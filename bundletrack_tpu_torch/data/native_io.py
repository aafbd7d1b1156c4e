"""PNG frames on disk: a zlib PNG codec in Python and a decode-ahead prefetcher.

The port's own copy of the pure-Python parts of
bundletrack_tpu/data/native_io.py (reference: src/DataLoader.cpp image
loading, src/Utils.cpp:49-68).  The JAX package decodes through a C++
library that it builds into native/ at first use; the port builds nothing
there.  It decodes in Python and overlaps the decoding with the tracker
through a thread pool (zlib releases the interpreter lock while it
inflates).  Decoding is exact either way, so the frames are bit-identical.
"""

from __future__ import annotations

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
# The PNG codec (no dependencies beyond zlib)
# ---------------------------------------------------------------------------


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
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    bpp = channels * (bits // 8)
    stride = w * bpp
    raw = raw.reshape(h, stride + 1)
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
        else:
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                if ft == 1:
                    cur[x] = (line[x] + a) & 0xFF
                elif ft == 3:
                    cur[x] = (line[x] + (a + b) // 2) & 0xFF
                elif ft == 4:
                    pp = a + b - c
                    pa, pb_, pc = abs(pp - a), abs(pp - b), abs(pp - c)
                    pred = a if (pa <= pb_ and pa <= pc) else (b if pb_ <= pc else c)
                    cur[x] = (line[x] + pred) & 0xFF
        recon[y] = cur.astype(np.uint8)
        prev = cur
    if color == 3:
        idxs = recon.reshape(h, w)
        return palette[idxs]
    if bits == 16:
        arr = recon.reshape(h, w, channels, 2)
        out = (arr[..., 0].astype(np.uint16) << 8) | arr[..., 1]
        return out[..., 0] if channels == 1 else out
    arr = recon.reshape(h, w, channels)
    return arr[..., 0] if channels == 1 else arr


def write_png(path: str, arr: np.ndarray) -> None:
    """Minimal PNG writer (for tests/tools): u8 gray/RGB or u16 gray."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint16:
        if arr.ndim != 2:
            raise ValueError("a 16-bit PNG must be gray [H, W]")
        color, bits = 0, 16
        payload = arr.astype(">u2").tobytes()
        stride = arr.shape[1] * 2
    elif arr.ndim == 2:
        color, bits = 0, 8
        payload = arr.astype(np.uint8).tobytes()
        stride = arr.shape[1]
    else:
        if arr.ndim != 3 or arr.shape[2] != 3:
            raise ValueError(f"an 8-bit PNG must be [H, W] or [H, W, 3], not {arr.shape}")
        color, bits = 2, 8
        payload = arr.astype(np.uint8).tobytes()
        stride = arr.shape[1] * 3
    h = arr.shape[0]
    rows = b"".join(
        b"\x00" + payload[y * stride : (y + 1) * stride] for y in range(h)
    )
    comp = zlib.compress(rows)

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
