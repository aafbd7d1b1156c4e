"""PNG frames on disk: a PNG codec and a decode-ahead prefetcher.

Counterpart of bundletrack_tpu/data/native_io.py (reference:
src/DataLoader.cpp image loading, src/Utils.cpp:49-68).  The JAX package
decodes through a C++ library that it builds into native/ at first use; the
port builds nothing there.  It parses the chunks in Python, inflates with
zlib and undoes the row filters in C (csrc/png_unfilter.c, built with the
host C compiler into _build/ at first use and called through ctypes); both
release the interpreter lock, so the prefetcher's threads decode in
parallel and overlap the tracker.  Decoding is exact, so the frames are
bit-identical to the JAX package's.  A failed build of the C function
raises: there is no slow fallback.
"""

from __future__ import annotations

import ctypes
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np


class SequencePrefetcher:
    """Decode-ahead access to a list of PNG paths: `get(i)` returns frame i
    and starts decoding the next `ahead` frames on `threads` threads."""

    def __init__(self, paths: Sequence[str], threads: int = 4, ahead: int = 8):
        self.paths = list(paths)
        self.ahead = ahead
        self._pool = ThreadPoolExecutor(max_workers=threads)
        self._pending = {}

    def _submit(self, idx: int) -> None:
        if 0 <= idx < len(self.paths) and idx not in self._pending:
            self._pending[idx] = self._pool.submit(read_png, self.paths[idx])

    def get(self, idx: int) -> np.ndarray:
        for j in range(idx, idx + self.ahead + 1):
            self._submit(j)
        # drop what lies behind: a sequence is read forwards
        for j in [j for j in self._pending if j < idx]:
            self._pending.pop(j).cancel()
        return self._pending.pop(idx).result()

    def close(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)
        self._pending.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# The PNG codec (zlib, and the row filters in C)
# ---------------------------------------------------------------------------

UNFILTER_SOURCE = "png_unfilter.c"
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _unfilter_c(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """The unfiltered rows [h, stride] u8 of zlib's output `raw` (h rows of
    a filter byte and `stride` bytes), by csrc/png_unfilter.c."""
    from bundletrack_tpu_torch.kernels import build

    lib = build.load(UNFILTER_SOURCE)
    fn = lib.unfilter
    fn.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u8p]
    fn.restype = ctypes.c_int
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != h * (stride + 1) or bpp < 1:
        raise ValueError(f"PNG data holds {raw.size} bytes, not {h} rows of 1 + {stride}")
    out = np.empty((h, stride), np.uint8)
    bad = fn(raw.ctypes.data_as(_u8p), h, stride, bpp, out.ctypes.data_as(_u8p))
    if bad >= 0:
        raise ValueError(f"PNG row {bad} has filter type {raw[bad * (stride + 1)]}, not 0-4")
    return out


def _unfilter_python(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """The plain version of `_unfilter_c`, one byte at a time: the tests
    hold the C function to it."""
    raw = np.asarray(raw, np.uint8).reshape(h, stride + 1)
    filters = raw[:, 0]
    recon = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        line = raw[y, 1:].astype(np.int32)
        ft = filters[y]
        if ft == 0:
            cur = line
        elif ft == 2:
            cur = (line + prev) & 0xFF
        elif ft in (1, 3, 4):
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                if ft == 1:
                    cur[x] = (line[x] + a) & 0xFF
                elif ft == 3:
                    cur[x] = (line[x] + (a + b) // 2) & 0xFF
                else:
                    pp = a + b - c
                    pa, pb_, pc = abs(pp - a), abs(pp - b), abs(pp - c)
                    pred = a if (pa <= pb_ and pa <= pc) else (b if pb_ <= pc else c)
                    cur[x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"PNG row {y} has filter type {ft}, not 0-4")
        recon[y] = cur.astype(np.uint8)
        prev = cur
    return recon


def read_png(path: str) -> np.ndarray:
    """Decode a PNG to a numpy array (u8 or u16)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"not a PNG: {path}")
    pos = 8
    idat = b""
    palette = None
    meta = None
    while pos + 8 <= len(data):
        (length,) = np.frombuffer(data[pos : pos + 4], ">u4")
        ctype = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        if ctype == b"IHDR":
            w, h = np.frombuffer(payload[:8], ">u4")
            bits, color, _, _, interlace = payload[8:13]
            if interlace != 0:
                raise ValueError(f"interlaced PNG unsupported: {path}")
            meta = (int(w), int(h), int(bits), int(color))
        elif ctype == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat += bytes(payload)
        elif ctype == b"IEND":
            break
        pos += 12 + int(length)
    w, h, bits, color = meta
    if bits not in (8, 16):
        raise ValueError(f"{bits}-bit PNG unsupported: {path}")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    bpp = channels * (bits // 8)
    recon = _unfilter_c(raw, h, w * bpp, bpp)
    if color == 3:
        idxs = recon.reshape(h, w)
        return palette[idxs]
    if bits == 16:
        arr = recon.reshape(h, w, channels, 2)
        out = (arr[..., 0].astype(np.uint16) << 8) | arr[..., 1]
        return out[..., 0] if channels == 1 else out
    arr = recon.reshape(h, w, channels)
    return arr[..., 0] if channels == 1 else arr


def _filter_rows(img: np.ndarray, bpp: int, types: np.ndarray) -> np.ndarray:
    """PNG rows [h, 1 + stride]: row y filtered with types[y] (0-4).  Every
    predictor reads unfiltered bytes, so all rows filter at once."""
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(x), a, b, (a + b) // 2, paeth])
    pred = preds[types, np.arange(len(x))]
    return np.concatenate([types[:, None].astype(np.uint8), ((x - pred) & 0xFF).astype(np.uint8)], axis=1)


def write_png(path: str, arr: np.ndarray, filter_type=0) -> None:
    """Minimal PNG writer (for tests/tools): u8 gray/RGB or u16 gray.

    `filter_type` is the PNG row filter, 0-4 (None, Sub, Up, Average,
    Paeth), one for every row or a sequence of one per row."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint16:
        if arr.ndim != 2:
            raise ValueError("a 16-bit PNG must be gray [H, W]")
        color, bits, bpp = 0, 16, 2
        img = arr.astype(">u2").view(np.uint8).reshape(arr.shape[0], -1)
    elif arr.ndim == 2:
        color, bits, bpp = 0, 8, 1
        img = arr.astype(np.uint8)
    else:
        if arr.ndim != 3 or arr.shape[2] != 3:
            raise ValueError(f"an 8-bit PNG must be [H, W] or [H, W, 3], not {arr.shape}")
        color, bits, bpp = 2, 8, 3
        img = arr.astype(np.uint8).reshape(arr.shape[0], -1)
    h = arr.shape[0]
    types = np.broadcast_to(np.asarray(filter_type, np.int64), (h,))
    if types.min(initial=0) < 0 or types.max(initial=0) > 4:
        raise ValueError(f"PNG filter types are 0-4, not {filter_type}")
    comp = zlib.compress(_filter_rows(img, bpp, types).tobytes())

    def chunk(ctype: bytes, data: bytes) -> bytes:
        crc = zlib.crc32(ctype + data) & 0xFFFFFFFF
        return (
            len(data).to_bytes(4, "big") + ctype + data + crc.to_bytes(4, "big")
        )

    ihdr = (
        int(arr.shape[1]).to_bytes(4, "big")
        + int(h).to_bytes(4, "big")
        + bytes([bits, color, 0, 0, 0])
    )
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", comp))
        f.write(chunk(b"IEND", b""))
