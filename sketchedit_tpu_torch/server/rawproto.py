"""Raw binary payload protocol for /edit (application/octet-stream); a copy
of ``sketchedit_tpu/server/rawproto.py``, byte for byte on the wire.

The JSON/base64-PNG content type costs the serving host a PNG decode +
encode per request (zlib on the request thread), and under many concurrent
clients that codec work, not the device, can bound throughput. This wire
format ships the pixels as-is, so a request is one memcpy on each side:

    request  = HEADER + image u8 RGB (h*w*3 bytes) + sketch u8 (h*w bytes)
    response = HEADER + composed u8 RGB (h*w*3)    + mask u8  (h*w)

HEADER (little-endian, 10 bytes): magic b"SKED", version u8 (1),
flags u8 (0), height u16, width u16. The response header carries the
response's own (h, w) — equal to the request's (outputs are restored to
the input size).

Base64-PNG stays the demo-facing content type; this is the
high-throughput machine-to-machine path (raw u8 at 256^2 is 256 KB vs
~150-200 KB for PNG — bytes are comparable, codec CPU is not).
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"SKED"
VERSION = 1
HEADER = struct.Struct("<4sBBHH")


class RawProtoError(ValueError):
    pass


def encode(image_u8: np.ndarray, plane_u8: np.ndarray) -> bytes:
    """(h,w,3) u8 + (h,w)/(h,w,1) u8 -> wire bytes (request or response)."""
    h, w = image_u8.shape[:2]
    if image_u8.shape != (h, w, 3) or image_u8.dtype != np.uint8:
        raise RawProtoError(f"image must be (h,w,3) uint8, "
                            f"got {image_u8.shape} {image_u8.dtype}")
    plane = plane_u8.reshape(h, w) if plane_u8.ndim == 3 else plane_u8
    if plane.shape != (h, w) or plane.dtype != np.uint8:
        raise RawProtoError(f"plane must be (h,w) uint8, "
                            f"got {plane_u8.shape} {plane_u8.dtype}")
    return (HEADER.pack(MAGIC, VERSION, 0, h, w)
            + np.ascontiguousarray(image_u8).tobytes()
            + np.ascontiguousarray(plane).tobytes())


def decode_frames(body: bytes, max_frames: int = 1024,
                  ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Wire bytes -> [((h,w,3) u8 image, (h,w,1) u8 plane), ...].

    A body is one or more concatenated frames (each self-describing:
    header + image + plane), which is the bulk request shape — N edits in
    one POST amortize the per-request HTTP/dispatch cost that bounds the
    loaded single-frame path on a small serving host. Raises
    RawProtoError on malformed input (maps to HTTP 400)."""
    frames = []
    off = 0
    while off < len(body):
        if len(body) - off < HEADER.size:
            raise RawProtoError(f"trailing {len(body) - off} bytes are "
                                "shorter than a frame header")
        magic, ver, _flags, h, w = HEADER.unpack_from(body, off)
        if magic != MAGIC:
            raise RawProtoError("bad magic (expected b'SKED')")
        if ver != VERSION:
            raise RawProtoError(f"unsupported version {ver}")
        if h < 1 or w < 1:
            raise RawProtoError(f"bad dims {h}x{w}")
        need = HEADER.size + h * w * 4
        if len(body) - off < need:
            raise RawProtoError(
                f"frame {len(frames)} truncated: {len(body) - off} bytes "
                f"< {need} for {h}x{w}")
        img = np.frombuffer(body, np.uint8, h * w * 3,
                            offset=off + HEADER.size).reshape(h, w, 3)
        plane = np.frombuffer(
            body, np.uint8, h * w,
            offset=off + HEADER.size + h * w * 3).reshape(h, w, 1)
        frames.append((img, plane))
        if len(frames) > max_frames:
            raise RawProtoError(f"more than {max_frames} frames")
        off += need
    if not frames:
        raise RawProtoError("empty body")
    return frames


def decode(body: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Wire bytes -> ((h,w,3) u8 image, (h,w,1) u8 plane); exactly one
    frame. Raises RawProtoError on malformed input (maps to HTTP 400)."""
    frames = decode_frames(body)
    if len(frames) != 1:
        raise RawProtoError(f"expected one frame, got {len(frames)}")
    return frames[0]
