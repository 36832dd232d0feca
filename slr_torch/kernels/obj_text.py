"""The OBJ text of a triangle mesh, formatted on the card
(``csrc/obj_text.cu``), and its plain version.

A mesh of N vertices and M faces makes N + M lines, the vertices' first:
``v {x:.6f} {y:.6f} {z:.6f} {c:.4f} {c:.4f} {c:.4f}`` (without colours
``v {x:.6f} {y:.6f} {z:.6f}``), then ``f {a+1} {b+1} {c+1}``, each ended by
a newline: byte for byte what Python's f-strings print for the float32
values widened to doubles, as ``.tolist()`` widens them. The digits come
from integer arithmetic on each float's bits, never from float arithmetic,
and are exact (the kernel's source says how). Domain: |x| * 10^k < 2^63
(|x| < 9.2e12 at 6 decimals); a number outside it makes
``text_length`` raise ``ValueError``, so no wrong digit is written.

The text is made in four steps, each its own call so that a writer can
time its launches apart from its two reads:

1. ``line_ends``: the length pass (one launch) and an inclusive scan of the
   lengths (``torch.cumsum``): ends (L + 1,) int64; ``ends[L] - ends[L - 1]``
   is 1 when a number lies outside the domain;
2. ``text_length``: one read of the last two ends: the text's byte count,
   or ``ValueError``;
3. ``write_text``: the write pass (one launch) into ``torch.empty`` bytes;
4. ``to_host``: one read of the bytes to the host.

``format_obj`` runs all four. A CPU tensor takes the plain version of each
pass (``line_ends_reference``, ``write_text_reference``), the same digit
arithmetic in int64 tensor ops: the lengths from digit counts alone, each
line written at its start in ``ends``. A CUDA tensor launches the kernels,
or raises. The recorder's counter ``launches.obj_text``
(``slr_torch.observability``) counts the launches: two a text. The kernel
replaces no TPU kernel: the JAX package formats its OBJ in Python.
"""

from __future__ import annotations

import ctypes

import torch

from slr_torch.kernels.build import bind, launch

_I64_MAX = (1 << 63) - 1
_OUTSIDE = ("obj_text: a number lies outside the domain |x| * 10^k < 2^63 "
            "(|x| < 9.2e12 at 6 decimals)")
_POW10 = torch.tensor([10 ** j for j in range(19)], dtype=torch.int64)


def _check(verts, cols, faces):
    """The inputs' contract, on both routes: the plain version refuses
    what the kernels refuse."""
    dev = verts.device
    want = [(verts, (verts.shape[0], 3), torch.float32),
            (faces, (faces.shape[0], 3), torch.int32)]
    if cols is not None:
        want.append((cols, (verts.shape[0],), torch.float32))
    for x, shape, dtype in want:
        if (tuple(x.shape) != shape or x.dtype != dtype or x.device != dev
                or not x.is_contiguous()):
            raise ValueError(f"obj_text: expected a contiguous {dtype} tensor of shape "
                             f"{shape} on {dev}, got {x.dtype} {tuple(x.shape)} "
                             f"on {x.device}")
    if verts.shape[0] + faces.shape[0] >= 2 ** 31:
        raise ValueError(f"obj_text: {verts.shape[0]} + {faces.shape[0]} lines, "
                         "more than 2^31 - 1")


def _check_ends(verts, faces, ends):
    L = verts.shape[0] + faces.shape[0]
    if tuple(ends.shape) != (L + 1,) or ends.dtype != torch.int64 or ends.device != verts.device:
        raise ValueError(f"obj_text: expected the (L + 1,) = ({L + 1},) int64 ends of "
                         f"line_ends on {verts.device}, got {ends.dtype} {tuple(ends.shape)}")


# ---- the plain version ------------------------------------------------------

def _fixed(x, k: int):
    """float32 ``x`` at ``k`` decimals: (negative, nan, inf, n, in_domain),
    n = |x| * 10^k rounded half to even, exact, for the finite values."""
    b = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = (b >> 31) == 1
    ex, man = (b >> 23) & 0xFF, b & 0x7FFFFF
    sub = ex == 0
    m = torch.where(sub, man, man | 0x800000)
    e = torch.where(sub, -149, ex - 150)
    p = m * 10 ** k                                    # < 2^44
    left = e.clamp(0, 62)
    ok = (e < 0) | ((e <= 62) & (p <= (torch.full_like(p, _I64_MAX) >> left)))
    n_left = torch.where(ok, p, 0) << left
    s = (-e).clamp(1, 62)
    q = p >> s
    r, half = p - (q << s), torch.ones_like(p) << (s - 1)
    n_right = torch.where(e < -62, 0, q + ((r > half) | ((r == half) & ((q & 1) == 1))).long())
    special = ex == 0xFF
    nan, inf = special & (man != 0), special & (man == 0)
    n = torch.where(special, 0, torch.where(e >= 0, n_left, n_right))
    return neg, nan, inf, n, ok | special


def _digits(v, chars: bool):
    """Decimal digits of ``v`` >= 0, left-aligned: (ascii (n, w) uint8, or
    None without ``chars``; count (n,))."""
    nd = 1 + (v[:, None] >= _POW10[1:]).sum(1)
    if not chars:
        return None, nd
    w = int(nd.max()) if v.numel() else 1
    power = (nd[:, None] - 1 - torch.arange(w)).clamp(min=0)
    return ((v[:, None] // _POW10[power]) % 10 + 48).to(torch.uint8), nd


def _literal(s: str, n: int, on=None):
    ch = torch.tensor(list(s.encode()), dtype=torch.uint8).expand(n, len(s))
    ln = torch.full((n,), len(s), dtype=torch.int64)
    return ch, ln if on is None else ln * on


def _float_pieces(x, k: int, chars: bool):
    neg, nan, inf, n, ok = _fixed(x, k)
    finite = ~(nan | inf)
    ich, ind = _digits(n // 10 ** k, chars)
    fch = None
    if chars:
        frac = n % 10 ** k
        fch = ((frac[:, None] // _POW10[torch.arange(k - 1, -1, -1)]) % 10 + 48).to(torch.uint8)
    size = x.shape[0]
    return [_literal("-", size, neg & ~nan), _literal("nan", size, nan),
            _literal("inf", size, inf), (ich, ind * finite), _literal(".", size, finite),
            (fch, k * finite.long())], ok


def _index_pieces(a, chars: bool):
    v = a.to(torch.int64) + 1
    ich, ind = _digits(v.abs(), chars)
    return [_literal("-", a.shape[0], v < 0), (ich, ind)]


def _lines(verts, cols, faces, chars: bool):
    """Each line's pieces ((ascii (n, w) or None without ``chars``, length
    (n,)) in order) and whether each number lies inside the domain, for the
    vertex lines and then the face lines."""
    nv, nf = verts.shape[0], faces.shape[0]
    vp, ok = [_literal("v", nv)], []
    for c in range(3):
        pieces, good = _float_pieces(verts[:, c], 6, chars)
        vp += [_literal(" ", nv), *pieces]
        ok.append(good)
    if cols is not None:
        pieces, good = _float_pieces(cols, 4, chars)
        vp += [_literal(" ", nv), *pieces] * 3
        ok.append(good)
    fp = [_literal("f", nf)]
    for c in range(3):
        fp += [_literal(" ", nf), *_index_pieces(faces[:, c], chars)]
    return ((vp + [_literal("\n", nv)], fp + [_literal("\n", nf)]),
            bool(torch.stack(ok).all()) if nv else True)


def _lengths(pieces):
    return sum(ln for _, ln in pieces)


def _put(text, pieces, start):
    """Store each line's pieces into ``text`` from its ``start`` on."""
    for ch, ln in pieces:
        j = torch.arange(ch.shape[1])
        keep = j[None, :] < ln[:, None]
        text[(start[:, None] + j)[keep]] = ch[keep]
        start = start + ln


def line_ends_reference(verts, cols, faces):
    """The plain version of ``line_ends``, the length pass: the lines'
    byte counts from their digit counts alone, and the domain flag."""
    _check(verts, cols, faces)
    (vp, fp), ok = _lines(verts, cols, faces, chars=False)
    lens = torch.cat([_lengths(vp), _lengths(fp), torch.tensor([0 if ok else 1])])
    return torch.cumsum(lens, 0)


def write_text_reference(verts, cols, faces, ends, n_bytes: int):
    """The plain version of ``write_text``, the write pass: each line's
    bytes stored at its start in ``ends``."""
    _check(verts, cols, faces)
    _check_ends(verts, faces, ends)
    (vp, fp), _ = _lines(verts, cols, faces, chars=True)
    text = torch.empty(n_bytes, dtype=torch.uint8)
    start = torch.cat([ends.new_zeros(1), ends[:-1]])[:-1]
    nv = verts.shape[0]
    _put(text, vp, start[:nv])
    _put(text, fp, start[nv:])
    return text


# ---- the kernels -------------------------------------------------------------

_ptr, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
library = bind("obj_text", {
    "slr_obj_lengths": (_i32, [_ptr] * 3 + [_i64] * 2 + [_ptr, _i32, _ptr]),
    "slr_obj_write": (_i32, [_ptr] * 3 + [_i64] * 2 + [_ptr, _ptr, _i32, _ptr]),
})


def _launch(fn, what: str, verts, cols, faces, *out):
    """One launch of ``fn`` on inputs that ``_check`` passed."""
    launch(library(), fn, f"OBJ text {what}", verts.device, verts.data_ptr(),
           None if cols is None else cols.data_ptr(), faces.data_ptr(), verts.shape[0],
           faces.shape[0], *(t.data_ptr() for t in out), counter="launches.obj_text")


def line_ends(verts, cols, faces):
    """Each line's end in the text, (L + 1,) int64 on the inputs' device,
    L = N + M; the last entry exceeds the one before by 1 when a number
    lies outside the domain. ``verts`` (N, 3) float32, ``cols`` (N,)
    float32 or None, ``faces`` (M, 3) int32, contiguous."""
    if verts.device.type == "cpu":
        return line_ends_reference(verts, cols, faces)
    _check(verts, cols, faces)
    lens = torch.zeros(verts.shape[0] + faces.shape[0] + 1, dtype=torch.int64,
                       device=verts.device)
    if lens.shape[0] > 1:
        _launch("slr_obj_lengths", "length", verts, cols, faces, lens)
    return torch.cumsum(lens, 0)


def text_length(ends) -> int:
    """The text's byte count from ``line_ends``' result: one read (a host
    sync for a CUDA tensor). Raises ``ValueError`` when a number lies
    outside the domain."""
    tail = ends[-2:].tolist()
    total = tail[0] if len(tail) == 2 else 0
    if tail[-1] != total:
        raise ValueError(_OUTSIDE)
    return total


def write_text(verts, cols, faces, ends, n_bytes: int):
    """The text, (n_bytes,) uint8 on the inputs' device; ``ends`` and
    ``n_bytes`` from ``line_ends`` and ``text_length``."""
    if verts.device.type == "cpu":
        return write_text_reference(verts, cols, faces, ends, n_bytes)
    _check(verts, cols, faces)
    _check_ends(verts, faces, ends)
    text = torch.empty(n_bytes, dtype=torch.uint8, device=verts.device)
    if ends.shape[0] > 1:
        _launch("slr_obj_write", "write", verts, cols, faces, ends, text)
    return text


def to_host(text):
    """The text on the host: one read (a host sync for a CUDA tensor) into
    page-locked memory, which the caching host allocator keeps (44.7 MB:
    0.86 ms, against 5.36 ms into pageable memory, on an H100 80GB HBM3)."""
    if text.device.type == "cpu":
        return text
    host = torch.empty(text.shape, dtype=torch.uint8, pin_memory=True)
    return host.copy_(text)


def format_obj(verts, cols, faces):
    """The mesh's OBJ lines, on the host: (bytes,) uint8."""
    ends = line_ends(verts, cols, faces)
    return to_host(write_text(verts, cols, faces, ends, text_length(ends)))
