"""ctypes bindings for the native host-runtime library (native/).

The port's own copy of splatloam_tpu/io/native.py.  The library is the
repository's host code (C++ on the CPU), shared by both packages; it is
no GPU kernel.  Loads libsplatloam_native.so (building it with `make -C native` on first
use if a toolchain is present) and exposes:
  lzf_decompress      — PCL binary_compressed codec
  read_files_batch    — threaded whole-file batch reads (I/O prefetch)
  filter_cloud_f32    — fused finite+range gate for [N,4] clouds

Every entry point has a pure-Python fallback, so the package works without
a compiler; ``available()`` reports which path is active.
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

from ..logging_utils import get_logger

logger = get_logger("native")

_REPO_ROOT = Path(__file__).resolve().parents[2]
_LIB_PATH = _REPO_ROOT / "native" / "libsplatloam_native.so"
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not _LIB_PATH.is_file():
        try:
            subprocess.run(["make", "-C", str(_REPO_ROOT / "native")],
                           check=True, capture_output=True, timeout=120)
        except Exception as e:
            logger.debug(f"native build unavailable: {e}")
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.lzf_decompress.restype = ctypes.c_long
        lib.lzf_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
        lib.read_files_batch.restype = None
        lib.read_files_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.c_int]
        lib.lz4_frame_decompress.restype = ctypes.c_long
        lib.lz4_frame_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
        lib.filter_cloud_f32.restype = ctypes.c_long
        lib.filter_cloud_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        logger.debug(f"native library loaded from {_LIB_PATH}")
    except OSError as e:
        logger.debug(f"native library load failed: {e}")
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def lzf_decompress(data: bytes, expected: int) -> bytes:
    lib = _load()
    if lib is None:
        from .pointcloud import _lzf_decompress
        return _lzf_decompress(data, expected)
    out = np.empty(expected, np.uint8)
    n = lib.lzf_decompress(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), expected)
    if n < 0:
        raise ValueError("malformed LZF stream")
    return out[:n].tobytes()


def _lz4_block_py(data: bytes, out: bytearray) -> None:
    ip, iend = 0, len(data)
    while ip < iend:
        token = data[ip]; ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = data[ip]; ip += 1
                lit += b
                if b != 255:
                    break
        out += data[ip:ip + lit]
        ip += lit
        if ip >= iend:
            break
        offset = data[ip] | (data[ip + 1] << 8)
        ip += 2
        mlen = token & 15
        if mlen == 15:
            while True:
                b = data[ip]; ip += 1
                mlen += b
                if b != 255:
                    break
        mlen += 4
        if offset == 0 or offset > len(out):
            raise ValueError("malformed LZ4 block")
        start = len(out) - offset
        for i in range(mlen):          # overlap-safe byte copy
            out.append(out[start + i])


def _lz4_frame_py(data: bytes) -> bytes:
    import struct
    if len(data) < 7 or struct.unpack_from("<I", data)[0] != 0x184D2204:
        raise ValueError("not an LZ4 frame")
    ip = 4
    flg = data[ip]; ip += 2              # FLG + BD
    if ((flg >> 6) & 3) != 1:
        raise ValueError("unsupported LZ4 frame version")
    if (flg >> 3) & 1:
        ip += 8                          # content size
    if flg & 1:
        ip += 4                          # dictionary ID
    ip += 1                              # header checksum
    block_checksum = (flg >> 4) & 1
    out = bytearray()
    while True:
        bsize = struct.unpack_from("<I", data, ip)[0]; ip += 4
        if bsize == 0:
            break
        stored = bsize >> 31
        bsize &= 0x7FFFFFFF
        blk = data[ip:ip + bsize]; ip += bsize
        if stored:
            out += blk
        else:
            _lz4_block_py(blk, out)
        if block_checksum:
            ip += 4
    return bytes(out)


def lz4_frame_decompress(data: bytes, expected: int) -> bytes:
    """LZ4 FRAME decode (roslz4 / MCAP chunk format); ``expected`` is the
    known uncompressed size (both containers record it)."""
    lib = _load()
    if lib is None:
        return _lz4_frame_py(data)
    out = np.empty(max(expected, 1), np.uint8)
    n = lib.lz4_frame_decompress(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(out))
    if n < 0:
        raise ValueError("malformed LZ4 frame")
    return out[:n].tobytes()


def read_files_batch(paths: list[str | Path], stride: int,
                     n_threads: int = 4):
    """Read whole files concurrently -> (buffer [n, stride] u8, sizes [n])."""
    lib = _load()
    n = len(paths)
    buffer = np.empty((n, stride), np.uint8)
    sizes = np.zeros(n, np.int64)
    if lib is None:
        for i, p in enumerate(paths):
            raw = Path(p).read_bytes()[:stride]
            buffer[i, :len(raw)] = np.frombuffer(raw, np.uint8)
            buffer[i, len(raw):] = 0
            sizes[i] = len(raw)
        return buffer, sizes
    c_paths = (ctypes.c_char_p * n)(
        *(str(p).encode() for p in paths))
    lib.read_files_batch(
        c_paths, n, buffer.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        stride, sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        n_threads)
    return buffer, sizes


def filter_cloud(xyzi: np.ndarray, rmin: float, rmax: float) -> np.ndarray:
    """[N, 4] float32 -> [M, 3] xyz with rmin < ||p|| <= rmax, finite."""
    xyzi = np.ascontiguousarray(xyzi, np.float32)
    lib = _load()
    if lib is None:
        xyz = xyzi[:, :3]
        r2 = np.sum(xyz * xyz, axis=1)
        ok = (np.isfinite(r2) & (r2 > rmin * rmin)
              & (r2 <= rmax * rmax))
        return np.ascontiguousarray(xyz[ok])
    out = np.empty((len(xyzi), 3), np.float32)
    kept = lib.filter_cloud_f32(
        xyzi.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(xyzi),
        rmin, rmax, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out[:kept]
