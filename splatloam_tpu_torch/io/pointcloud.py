"""Point cloud sequence readers: BIN / PLY / PCD / ROSBAG.

The port's own copy of splatloam_tpu/io/pointcloud.py (numpy only; the
timestamp-file reader is io/trajectory.py's).  Re-implements ref utils/pointcloud_utils.py:17-212 without Open3D or the
``rosbags`` package: PLY via io.ply, PCD via a native parser (ascii,
binary, binary_compressed/LZF), rosbags via io.rosbag (pure-python ROS1
bag + ROS2 sqlite3 readers with vectorized PointCloud2 decode).
"""
from __future__ import annotations

import re
from pathlib import Path
import numpy as np

from ..config import PointCloudReaderConfig, PointCloudReaderType
from ..logging_utils import get_logger
from . import ply as plyio
from .trajectory import read_timestamps

logger = get_logger("pointcloud")


def natsort_key(path: Path):
    """Natural sort ('2.bag' < '10.bag'), replaces natsort dependency."""
    return [int(t) if t.isdigit() else t
            for t in re.split(r"(\d+)", path.name)]


def str_to_timestamp(stem: str) -> float:
    """'<txt>_<sec>.<nsec>_<txt>' -> seconds (ref :189-201)."""
    nums = re.findall(r"\d+", stem)
    if len(nums) == 1:
        return float(nums[0])
    if len(nums) == 2:
        return float(nums[0]) + float(nums[1]) / 1e9
    raise ValueError(f"Invalid timestamp {stem}")


class PointCloudReader:
    """Base class (ref utils/pointcloud_utils.py:17-29)."""

    def __init__(self, config: PointCloudReaderConfig):
        self.n_clouds = 0
        self.current_index = 0

    def __len__(self):
        return self.n_clouds

    def __iter__(self):
        return self


class PointCloudReader_Collections(PointCloudReader):
    """Folder-of-files datasets with timestamps from file or filename
    (ref :32-61).  A one-file read-ahead thread overlaps disk I/O with the
    consumer's device compute."""

    def __init__(self, config: PointCloudReaderConfig):
        super().__init__(config)
        self.filenames: list[Path] = []
        self._prefetch = None
        if config.timestamp_filename is not None:
            self.timestamps = read_timestamps(config.timestamp_filename)
            self.get_timestamp = \
                lambda p: self.timestamps[self.current_index - 1]
        elif config.timestamp_from_filename:
            self.get_timestamp = lambda p: str_to_timestamp(p.stem)
        else:
            self.get_timestamp = lambda p: 0.0

    def _submit(self, index: int):
        import concurrent.futures
        if not hasattr(self, "_pool"):
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1)
        return self._pool.submit(self.read_cloud, self.filenames[index])

    def __next__(self):
        if self.current_index >= self.n_clouds:
            raise StopIteration
        filename = self.filenames[self.current_index]
        pending = self._prefetch
        self.current_index += 1
        cloud = pending.result() if pending is not None \
            else self.read_cloud(filename)
        if self.current_index < self.n_clouds:
            self._prefetch = self._submit(self.current_index)
        else:
            self._prefetch = None
        return cloud, self.get_timestamp(filename)

    def read_cloud(self, filename: Path) -> np.ndarray:
        raise NotImplementedError


class PointCloudReader_BIN(PointCloudReader_Collections):
    """KITTI float4 [x y z intensity] binaries (ref :64-89)."""

    def __init__(self, config: PointCloudReaderConfig):
        super().__init__(config)
        self.filenames = sorted(Path(config.cloud_folder).glob("*.bin"))
        self.n_clouds = len(self.filenames)
        self.bin_format = config.bin_format or "<f4"

    def read_cloud(self, filename: Path) -> np.ndarray:
        cloud = np.fromfile(filename, self.bin_format).reshape(-1, 4)
        return cloud[:, :3].astype(np.float32)


class PointCloudReader_PLY(PointCloudReader_Collections):
    """(ref :92-111, via our own PLY parser)"""

    def __init__(self, config: PointCloudReaderConfig):
        super().__init__(config)
        self.filenames = sorted(Path(config.cloud_folder).glob("*.ply"))
        self.n_clouds = len(self.filenames)

    def read_cloud(self, filename: Path) -> np.ndarray:
        d = plyio.read_ply(filename)
        return np.stack([d["x"], d["y"], d["z"]], axis=1).astype(np.float32)


class PointCloudReader_PCD(PointCloudReader_Collections):
    """(ref :114-134, via our own PCD parser)"""

    def __init__(self, config: PointCloudReaderConfig):
        super().__init__(config)
        self.filenames = sorted(Path(config.cloud_folder).glob("*.pcd"))
        self.n_clouds = len(self.filenames)
        logger.info(f"Found {self.n_clouds} pcd clouds")

    def read_cloud(self, filename: Path) -> np.ndarray:
        return read_pcd(filename)


class PointCloudReader_ROSBAG(PointCloudReader):
    """ROS1 .bag / ROS2 sqlite3 bags (ref :137-178, self-implemented)."""

    def __init__(self, config: PointCloudReaderConfig):
        super().__init__(config)
        from .rosbag import BagSequenceReader
        folder = Path(config.cloud_folder)
        if folder.is_file():
            bags = [folder]
        else:
            bags = sorted(folder.glob("*.bag"), key=natsort_key)
            if not bags:
                bags = sorted(folder.glob("*.db3"), key=natsort_key)
            if not bags:
                bags = sorted(folder.glob("*.mcap"), key=natsort_key)
        logger.debug(f"Opening rosbags: {bags}")
        self._reader = BagSequenceReader(bags, config.rosbag_topic)
        self.n_clouds = self._reader.message_count

    def __next__(self):
        xyz, timestamp = next(self._reader)
        return xyz, timestamp


pointcloud_reader_available = {
    PointCloudReaderType.bin: PointCloudReader_BIN,
    PointCloudReaderType.ply: PointCloudReader_PLY,
    PointCloudReaderType.pcd: PointCloudReader_PCD,
    PointCloudReaderType.rosbag: PointCloudReader_ROSBAG,
}


# ---------------------------------------------------------------------------
# PCD parsing (ascii / binary / binary_compressed)
# ---------------------------------------------------------------------------

_PCD_TYPES = {("F", 4): "<f4", ("F", 8): "<f8",
              ("I", 1): "<i1", ("I", 2): "<i2", ("I", 4): "<i4",
              ("U", 1): "<u1", ("U", 2): "<u2", ("U", 4): "<u4",
              ("U", 8): "<u8"}


def _lzf_decompress(data: bytes, expected: int) -> bytes:
    """Pure-python LZF decompression (PCL's binary_compressed codec)."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < expected:
        ctrl = data[i]
        i += 1
        if ctrl < 32:  # literal run
            run = ctrl + 1
            out += data[i:i + run]
            i += run
        else:  # back reference
            length = ctrl >> 5
            if length == 7:
                length += data[i]
                i += 1
            ref = len(out) - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            for _ in range(length + 2):
                out.append(out[ref])
                ref += 1
    return bytes(out)


def read_pcd(filename: str | Path) -> np.ndarray:
    """Parse a .pcd file, returning [N, 3] float32 xyz."""
    with open(filename, "rb") as f:
        raw = f.read()
    lines = []
    pos = 0
    header: dict[str, list[str]] = {}
    while True:
        nl = raw.find(b"\n", pos)
        line = raw[pos:nl].decode("ascii", errors="replace").strip()
        pos = nl + 1
        if line.startswith("#"):
            continue
        tok = line.split()
        if tok:
            header[tok[0].upper()] = tok[1:]
        lines.append(line)
        if tok and tok[0].upper() == "DATA":
            break

    fields = header["FIELDS"]
    sizes = [int(s) for s in header["SIZE"]]
    types = header["TYPE"]
    counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
    n_points = int(header["POINTS"][0])
    mode = header["DATA"][0].lower()

    np_fields = []
    for name, size, typ, count in zip(fields, sizes, types, counts):
        base = _PCD_TYPES[(typ, size)]
        for c in range(count):
            np_fields.append((f"{name}_{c}" if count > 1 else name, base))
    dtype = np.dtype(np_fields)

    if mode == "ascii":
        body = raw[pos:].decode("ascii", errors="replace")
        rows = np.loadtxt(body.splitlines()[:n_points], ndmin=2)
        data = {name: rows[:, i] for i, (name, _) in enumerate(np_fields)}
    else:
        if mode == "binary_compressed":
            comp_size, uncomp_size = np.frombuffer(
                raw[pos:pos + 8], "<u4")
            from . import native
            blob = native.lzf_decompress(raw[pos + 8:pos + 8 + comp_size],
                                         int(uncomp_size))
            # binary_compressed stores fields SOA, not AOS
            data = {}
            off = 0
            for name, base in np_fields:
                itemsize = np.dtype(base).itemsize
                data[name] = np.frombuffer(
                    blob, base, count=n_points, offset=off)
                off += itemsize * n_points
        else:
            arr = np.frombuffer(raw[pos:pos + n_points * dtype.itemsize],
                                dtype=dtype)
            data = {name: arr[name] for name, _ in np_fields}
    xyz = np.stack([data["x"], data["y"], data["z"]], axis=1)
    return np.ascontiguousarray(xyz).astype(np.float32)
