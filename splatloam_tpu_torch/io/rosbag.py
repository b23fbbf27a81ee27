"""Self-contained rosbag readers (ROS1 .bag v2.0 and ROS2 sqlite3 .db3).

The port's own copy of splatloam_tpu/io/rosbag.py (numpy, sqlite3 and
the standard library).  Replaces the ``rosbags`` package used at ref utils/pointcloud_utils.py:
137-178.  Only sensor_msgs/PointCloud2 decoding is implemented (that is all
the reference consumes); the field->numpy-dtype mapping mirrors
ref utils/pointcloud_utils.py:301-345 and the vendored ROS point_cloud2.py.

ROS1 bags: sequential chunk walk (none/bz2/lz4 chunk compression — LZ4
frames decoded by the native library or its pure-python fallback),
message counts from ChunkInfo records so __len__ is cheap.  ROS2 bags:
sqlite3 (stdlib) + a minimal CDR deserializer, and MCAP containers.
"""
from __future__ import annotations

import bz2
import sqlite3
import struct
from pathlib import Path

import numpy as np

from ..logging_utils import get_logger

logger = get_logger("rosbag")

# PointField datatype codes (sensor_msgs/PointField)
_PF_DTYPES = {1: "i1", 2: "u1", 3: "i2", 4: "u2",
              5: "i4", 6: "u4", 7: "f4", 8: "f8"}


def _fields_dtype(fields, point_step, bigendian):
    names, formats, offsets = [], [], []
    bo = ">" if bigendian else "<"
    for i, (name, offset, datatype, count) in enumerate(fields):
        base = np.dtype(bo + _PF_DTYPES[datatype])
        if not name:
            name = f"unnamed_field_{i}"
        for c in range(count):
            names.append(f"{name}_{c}" if count > 1 else name)
            formats.append(base.str)
            offsets.append(offset + c * base.itemsize)
    return np.dtype({"names": names, "formats": formats,
                     "offsets": offsets, "itemsize": point_step})


def decode_pointcloud2(fields, point_step, bigendian, data, n_points):
    """-> ([N, 3] float32 xyz).  Vectorized via a structured view."""
    dtype = _fields_dtype(fields, point_step, bigendian)
    pts = np.frombuffer(data, dtype=dtype, count=n_points)
    xyz = np.stack([pts["x"], pts["y"], pts["z"]], axis=1)
    return np.ascontiguousarray(xyz).astype(np.float32)


# ---------------------------------------------------------------------------
# ROS1 serialization of sensor_msgs/PointCloud2
# ---------------------------------------------------------------------------

class _Ros1Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def u8(self):
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u32(self):
        v = struct.unpack_from("<I", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def string(self):
        n = self.u32()
        s = self.buf[self.pos:self.pos + n]
        self.pos += n
        return s.decode("utf-8", errors="replace")

    def raw(self, n):
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b


def parse_ros1_pointcloud2(payload: bytes):
    r = _Ros1Reader(payload)
    r.u32()                      # header.seq
    sec, nsec = r.u32(), r.u32()  # header.stamp
    r.string()                   # header.frame_id
    height, width = r.u32(), r.u32()
    n_fields = r.u32()
    fields = []
    for _ in range(n_fields):
        name = r.string()
        offset = r.u32()
        datatype = r.u8()
        count = r.u32()
        fields.append((name, offset, datatype, count))
    bigendian = bool(r.u8())
    point_step = r.u32()
    r.u32()                      # row_step
    data_len = r.u32()
    data = r.raw(data_len)
    xyz = decode_pointcloud2(fields, point_step, bigendian, data,
                             height * width)
    return xyz, sec + nsec / 1e9


# ---------------------------------------------------------------------------
# ROS2 CDR serialization of sensor_msgs/msg/PointCloud2
# ---------------------------------------------------------------------------

class _CdrReader:
    def __init__(self, buf: bytes):
        # 4-byte encapsulation: {0x00, 0x01}=CDR_LE, {0x00, 0x00}=CDR_BE
        self.little = buf[1] == 0x01
        self.buf = buf
        self.pos = 4

    def _align(self, n):
        # alignment origin is the byte after the encapsulation header
        rem = (self.pos - 4) % n
        if rem:
            self.pos += n - rem

    def _unpack(self, fmt, size, align):
        self._align(align)
        bo = "<" if self.little else ">"
        v = struct.unpack_from(bo + fmt, self.buf, self.pos)[0]
        self.pos += size
        return v

    def u8(self):
        return self._unpack("B", 1, 1)

    def u32(self):
        return self._unpack("I", 4, 4)

    def i32(self):
        return self._unpack("i", 4, 4)

    def string(self):
        n = self.u32()  # includes the null terminator
        s = self.buf[self.pos:self.pos + n - 1]
        self.pos += n
        return s.decode("utf-8", errors="replace")

    def raw(self, n):
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b


def parse_cdr_pointcloud2(payload: bytes):
    r = _CdrReader(payload)
    sec, nsec = r.i32(), r.u32()   # header.stamp
    r.string()                     # header.frame_id
    height, width = r.u32(), r.u32()
    n_fields = r.u32()
    fields = []
    for _ in range(n_fields):
        name = r.string()
        offset = r.u32()
        datatype = r.u8()
        count = r.u32()
        fields.append((name, offset, datatype, count))
    bigendian = bool(r.u8())
    point_step = r.u32()
    r.u32()                        # row_step
    data_len = r.u32()
    data = r.raw(data_len)
    xyz = decode_pointcloud2(fields, point_step, bigendian, data,
                             height * width)
    return xyz, sec + nsec / 1e9


# ---------------------------------------------------------------------------
# ROS1 bag container (format v2.0)
# ---------------------------------------------------------------------------

_OP_MESSAGE = 0x02
_OP_BAGHDR = 0x03
_OP_INDEX = 0x04
_OP_CHUNK = 0x05
_OP_CONNECTION = 0x07
_OP_CHUNKINFO = 0x06


def _parse_header(buf: bytes) -> dict[str, bytes]:
    out = {}
    pos = 0
    while pos < len(buf):
        n = struct.unpack_from("<I", buf, pos)[0]
        pos += 4
        field = buf[pos:pos + n]
        pos += n
        eq = field.index(b"=")
        out[field[:eq].decode()] = field[eq + 1:]
    return out


class Ros1Bag:
    """Single .bag file: connection map, chunk offsets, message counts."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self.connections: dict[int, dict] = {}
        self.chunk_positions: list[int] = []
        self.counts: dict[int, int] = {}
        with open(self.path, "rb") as f:
            magic = f.readline()
            if not magic.startswith(b"#ROSBAG V2.0"):
                raise ValueError(f"{path}: not a ROS1 v2.0 bag")
            self._scan(f)

    def _read_record(self, f, skip_data=False):
        head = f.read(4)
        if len(head) < 4:
            return None, None, None
        hlen = struct.unpack("<I", head)[0]
        header = _parse_header(f.read(hlen))
        dlen = struct.unpack("<I", f.read(4))[0]
        if skip_data:
            pos = f.tell()
            f.seek(dlen, 1)
            return header, None, pos
        return header, f.read(dlen), None

    def _scan(self, f):
        while True:
            pos = f.tell()
            head = f.read(4)
            if len(head) < 4:
                break
            hlen = struct.unpack("<I", head)[0]
            header = _parse_header(f.read(hlen))
            op = header.get("op", b"\x00")[0]
            dlen = struct.unpack("<I", f.read(4))[0]
            if op == _OP_CONNECTION:
                data = f.read(dlen)
                conn = struct.unpack("<I", header["conn"])[0]
                chdr = _parse_header(data)
                self.connections[conn] = {
                    "topic": header["topic"].decode(),
                    "type": chdr.get("type", b"").decode(),
                }
            elif op == _OP_CHUNK:
                self.chunk_positions.append(pos)
                f.seek(dlen, 1)
            elif op == _OP_CHUNKINFO:
                data = f.read(dlen)
                dpos = 0
                while dpos < len(data):
                    conn, count = struct.unpack_from("<II", data, dpos)
                    dpos += 8
                    self.counts[conn] = self.counts.get(conn, 0) + count
            else:
                f.seek(dlen, 1)

    def conn_ids_for_topic(self, topic: str) -> set[int]:
        return {cid for cid, c in self.connections.items()
                if c["topic"] == topic}

    def count_for_topic(self, topic: str) -> int:
        return sum(self.counts.get(cid, 0)
                   for cid in self.conn_ids_for_topic(topic))

    def messages(self, topic: str):
        """Yield raw ROS1-serialized payloads for a topic, in bag order."""
        wanted = self.conn_ids_for_topic(topic)
        if not wanted:
            avail = {c["topic"] for c in self.connections.values()}
            logger.error(f"Topic {topic} not available in {avail}")
            return
        with open(self.path, "rb") as f:
            for cpos in self.chunk_positions:
                f.seek(cpos)
                header, data, _ = self._read_record(f)
                compression = header.get("compression", b"none").decode()
                if compression == "bz2":
                    data = bz2.decompress(data)
                elif compression == "lz4":
                    # roslz4 writes LZ4 frames; decode with the native/
                    # pure-python implementation (no lz4 package needed)
                    from .native import lz4_frame_decompress
                    expected = (struct.unpack("<I", header["size"])[0]
                                if "size" in header else 0)
                    data = lz4_frame_decompress(data, expected
                                                or 4 * len(data))
                pos = 0
                while pos < len(data):
                    hlen = struct.unpack_from("<I", data, pos)[0]
                    pos += 4
                    rhdr = _parse_header(data[pos:pos + hlen])
                    pos += hlen
                    dlen = struct.unpack_from("<I", data, pos)[0]
                    pos += 4
                    op = rhdr.get("op", b"\x00")[0]
                    if op == _OP_MESSAGE:
                        conn = struct.unpack("<I", rhdr["conn"])[0]
                        if conn in wanted:
                            yield data[pos:pos + dlen]
                    pos += dlen


class Ros2Bag:
    """ROS2 sqlite3 bag (.db3)."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self.db = sqlite3.connect(f"file:{path}?mode=ro", uri=True)

    def count_for_topic(self, topic: str) -> int:
        cur = self.db.execute(
            "SELECT COUNT(*) FROM messages m JOIN topics t "
            "ON m.topic_id = t.id WHERE t.name = ?", (topic,))
        return cur.fetchone()[0]

    def messages(self, topic: str):
        cur = self.db.execute(
            "SELECT m.data FROM messages m JOIN topics t "
            "ON m.topic_id = t.id WHERE t.name = ? "
            "ORDER BY m.timestamp", (topic,))
        for (payload,) in cur:
            yield payload


_MCAP_MAGIC = b"\x89MCAP0\r\n"


class McapBag:
    """ROS2 MCAP bag (.mcap) — linear-scan reader, no index required.

    The reference reads these through the `rosbags` package's AnyReader;
    this is the self-contained equivalent for CDR-encoded topics.
    Supports uncompressed chunks natively and zstd/lz4 chunks when the
    optional codecs are importable.  Messages are yielded in log-time
    order (sorted; recorders write in order anyway).
    """

    def __init__(self, path: Path):
        self.path = Path(path)
        import mmap
        self._fh = open(self.path, "rb")
        if self._fh.read(8) != _MCAP_MAGIC:
            self._fh.close()
            raise ValueError(f"{path} is not an MCAP file")
        self._mm = memoryview(mmap.mmap(self._fh.fileno(), 0,
                                        access=mmap.ACCESS_READ))
        self._channels = {}          # id -> topic
        # (log_time, channel_id, chunk_locator | None, payload_off, len):
        # the index holds offsets only — payloads (and chunk contents) are
        # decoded on demand in messages(), with a one-chunk cache, so a
        # multi-GB bag costs O(index) host RAM, not O(file).
        self._index = []
        self._chunk_cache = (None, b"")
        self._scan_top()
        self._index.sort(key=lambda m: m[0])

    @staticmethod
    def _string(mv, o):
        (n,) = struct.unpack_from("<I", mv, o)
        return bytes(mv[o + 4:o + 4 + n]).decode(), o + 4 + n

    @staticmethod
    def _decode_chunk(body):
        (usize,) = struct.unpack_from("<Q", body, 16)
        comp, co = McapBag._string(body, 28)
        (rlen,) = struct.unpack_from("<Q", body, co)
        records = bytes(body[co + 8:co + 8 + rlen])
        if comp == "zstd":
            import zstandard  # optional codec
            records = zstandard.ZstdDecompressor().decompress(
                records, max_output_size=usize)
        elif comp == "lz4":
            from .native import lz4_frame_decompress
            records = lz4_frame_decompress(records, usize)
        elif comp not in ("", "none"):
            raise ValueError(
                f"unsupported MCAP chunk compression {comp!r}")
        return records

    def _scan_messages(self, mv, chunk_loc, base):
        """Index Channel/Message records in ``mv``; payload offsets are
        relative to the file (chunk_loc None) or the decompressed chunk."""
        o = 0
        while o + 9 <= len(mv):
            op = mv[o]
            (length,) = struct.unpack_from("<Q", mv, o + 1)
            body = mv[o + 9:o + 9 + length]
            if op == 0x04:                        # Channel
                (cid,) = struct.unpack_from("<H", body, 0)
                topic, _ = self._string(body, 4)  # skip schema_id u16
                self._channels[cid] = topic
            elif op == 0x05:                      # Message
                (cid,) = struct.unpack_from("<H", body, 0)
                (log_time,) = struct.unpack_from("<Q", body, 6)
                self._index.append((log_time, cid, chunk_loc,
                                    base + o + 9 + 22, length - 22))
            elif op == 0x06 and chunk_loc is None:  # Chunk
                loc = (base + o + 9, length)
                records = self._decode_chunk(body)
                self._scan_messages(memoryview(records), loc, 0)
            elif op == 0x02:                      # Footer: stop
                return
            o += 9 + length

    def _scan_top(self):
        self._scan_messages(self._mm[8:], None, 8)

    def _chunk_records(self, loc):
        if self._chunk_cache[0] != loc:
            off, length = loc
            body = self._mm[off:off + length]
            self._chunk_cache = (loc, self._decode_chunk(body))
        return self._chunk_cache[1]

    def count_for_topic(self, topic: str) -> int:
        ids = {c for c, t in self._channels.items() if t == topic}
        return sum(1 for _, cid, *_ in self._index if cid in ids)

    def messages(self, topic: str):
        ids = {c for c, t in self._channels.items() if t == topic}
        for _, cid, loc, off, length in self._index:
            if cid not in ids:
                continue
            buf = self._mm if loc is None else self._chunk_records(loc)
            yield bytes(buf[off:off + length])


class BagSequenceReader:
    """Iterate (xyz, timestamp) over PointCloud2 msgs across many bags."""

    def __init__(self, paths: list[Path], topic: str):
        self.topic = topic
        self.bags = []
        for p in paths:
            p = Path(p)
            if p.suffix == ".db3":
                self.bags.append(("ros2", Ros2Bag(p)))
            elif p.suffix == ".mcap":
                self.bags.append(("ros2", McapBag(p)))
            else:
                self.bags.append(("ros1", Ros1Bag(p)))
        self.message_count = sum(b.count_for_topic(topic)
                                 for _, b in self.bags)
        self._iter = self._make_iter()

    def _make_iter(self):
        for kind, bag in self.bags:
            parse = (parse_ros1_pointcloud2 if kind == "ros1"
                     else parse_cdr_pointcloud2)
            for payload in bag.messages(self.topic):
                yield parse(payload)

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._iter)
