"""Dataset readers: EuRoC ASL directories and ground-truth CSVs.

Port of ``lfvio_tpu.runtime.datasets`` (the reference's ROS-bag ingestion
and benchmark_publisher GT replay, benchmark_publisher_node.cpp:33-126):
file readers that feed the same measurement stream as the synthetic world,
('imu', t, acc, gyr) and ('frame', t, image_loader) items in time order.
The CSV readers are numpy copies of the JAX package's.

The JAX package decodes frames with ``cv2.imread``; the port decodes PNG
itself (stdlib ``zlib`` and numpy), so it needs no image library.
``read_png_gray`` takes what EuRoC stores: 8-bit greyscale, non-interlaced,
with any of the five row filters. Any other colour type, bit depth or
interlace method raises ``ValueError``.
"""

from __future__ import annotations

import csv
import os
import struct
import zlib
from typing import Callable, Iterator

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOUR_TYPES = {0: "greyscale", 2: "RGB", 3: "palette", 4: "greyscale+alpha",
                 6: "RGBA"}


def _png_chunks(data: bytes):
    """(type, payload) of each chunk, CRCs checked."""
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(payload) != n or zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r} is truncated or fails its CRC")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG ends before its IEND chunk")


def _unfilter(filt, ftype):
    """Undo the PNG row filters of an 8-bit, one-byte-per-pixel image.

    ``filt`` [H, W] holds the filtered bytes, ``ftype`` [H] each row's
    filter (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth). A reconstructed byte
    depends on its left, upper and upper-left neighbours, so all pixels on
    one anti-diagonal r + x = s are independent: the image is rebuilt in
    H + W - 1 vectorized steps, each applying every row's own filter."""
    H, W = filt.shape
    # Reconstructed bytes with a zero row above and a zero column to the
    # left: the bytes PNG defines outside the image.
    rec = np.zeros((H + 1, W + 1), np.int16)
    flat = rec.reshape(-1)
    filt = filt.astype(np.int16)
    ftype = np.asarray(ftype)
    rows = np.arange(H)
    for s in range(H + W - 1):
        r = rows[max(0, s - W + 1):min(H, s + 1)]
        x = s - r
        here = (r + 1) * (W + 1) + x + 1
        a = flat[here - 1]  # left
        b = flat[here - (W + 1)]  # up
        c = flat[here - (W + 2)]  # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(ftype[r], (np.zeros_like(a), a, b, (a + b) >> 1, paeth))
        flat[here] = (filt[r, x] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8)


def decode_png_gray(data: bytes) -> np.ndarray:
    """[H, W] uint8 pixels of an 8-bit greyscale, non-interlaced PNG."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    header, idat = None, []
    for kind, payload in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    W, H, depth, colour, compression, filter_method, interlace = header
    if colour != 0:
        raise ValueError(f"PNG colour type {colour} "
                         f"({_COLOUR_TYPES.get(colour, 'unknown')}): only 8-bit greyscale "
                         "(colour type 0) is read")
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth}: only 8-bit greyscale is read")
    if interlace != 0:
        raise ValueError(f"PNG interlace method {interlace} (Adam7): only "
                         "non-interlaced images are read")
    if compression != 0 or filter_method != 0:
        raise ValueError(f"PNG compression method {compression} / filter method "
                         f"{filter_method}: only method 0 is defined")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (W + 1):
        raise ValueError(f"PNG image data holds {raw.size} bytes, not {H * (W + 1)} "
                         f"for {W}x{H}")
    raw = raw.reshape(H, W + 1)
    ftype = raw[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG row filter type {int(ftype.max())}: only 0-4 are defined")
    return _unfilter(raw[:, 1:], ftype)


def read_png_gray(path: str) -> np.ndarray:
    """[H, W] uint8 pixels of an 8-bit greyscale PNG file."""
    with open(path, "rb") as f:
        return decode_png_gray(f.read())


def read_euroc_imu(path: str):
    """mav0/imu0/data.csv: t[ns], wx, wy, wz, ax, ay, az."""
    out = []
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            t = float(row[0]) * 1e-9
            gyr = np.array([float(row[1]), float(row[2]), float(row[3])])
            acc = np.array([float(row[4]), float(row[5]), float(row[6])])
            out.append((t, acc, gyr))
    return out


def read_euroc_cam_index(path: str):
    """mav0/cam0/data.csv: t[ns], filename."""
    out = []
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            out.append((float(row[0]) * 1e-9, row[1].strip()))
    return out


def read_euroc_groundtruth(path: str):
    """state_groundtruth_estimate0/data.csv (or benchmark_publisher's vendored
    copies, reference benchmark_publisher/config/*/data.csv):
    t[ns], p(3), q_wxyz(4), v(3), bw(3), ba(3)."""
    ts, ps, qs = [], [], []
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            ts.append(float(row[0]) * 1e-9)
            ps.append([float(row[1]), float(row[2]), float(row[3])])
            qs.append([float(row[4]), float(row[5]), float(row[6]), float(row[7])])
    return np.asarray(ts), np.asarray(ps), np.asarray(qs)


def euroc_stream(mav0_dir: str, cam: str = "cam0") -> Iterator:
    """Yield the merged measurement stream for a EuRoC sequence directory.

    Frames carry a lazy loader (greyscale float32 array) so images are only
    decoded when consumed.
    """
    imu = read_euroc_imu(os.path.join(mav0_dir, "imu0", "data.csv"))
    cams = read_euroc_cam_index(os.path.join(mav0_dir, cam, "data.csv"))
    img_dir = os.path.join(mav0_dir, cam, "data")

    def loader(fname: str) -> Callable[[], np.ndarray]:
        def load():
            return read_png_gray(os.path.join(img_dir, fname)).astype(np.float32)

        return load

    stream = [("imu", t, acc, gyr) for (t, acc, gyr) in imu]
    stream += [("frame", t, loader(fn)) for (t, fn) in cams]
    stream.sort(key=lambda e: e[1])
    return iter(stream)


def run_sequence(pipeline, stream, max_frames: int | None = None):
    """Drive a VioPipeline from a dataset stream (frames carry loaders)."""
    n = 0
    for item in stream:
        if item[0] == "imu":
            pipeline.feed_imu(item[1], item[2], item[3])
        else:
            img = item[2]() if callable(item[2]) else item[2]
            pipeline.feed_frame(item[1], img)
            n += 1
            if max_frames and n >= max_frames:
                break
    return pipeline.est
