"""slr_torch.io — persistence (port of ``slr.io``).

PLY point-cloud export and import through the port's own native C++ writer
(``slr_torch/native/plyio.cpp``, built by g++; a failed build raises), OBJ
export, calibration as JSON and as cv::FileStorage YAML, scan image
folders, and stage checkpoints as .npz. Every file is the reference's
format, so a session written by either package opens in the other.
Arrays come back as numpy; cameras on the device the caller names.
"""

from slr_torch.io.ply import write_ply, read_ply, write_obj
from slr_torch.io.calibio import save_calibration, load_calibration
from slr_torch.io.checkpoint import (save_stage, load_stage, peek_stage, save_ba_state,
                                     load_ba_state)
from slr_torch.io.opencv_fs import (
    read_opencv_yaml, write_opencv_yaml,
    save_calibration_opencv, load_calibration_opencv,
)
from slr_torch.io.images import (
    load_scan_folder, save_scan_folder, read_pgm, write_pgm,
)
