"""Wire format: typed flat-array messages for client<->server sync (the
port's copy of the JAX package's `collab/wire.py`: the same bytes for the
same dict, so a client of either package talks to a server of the other).

Replaces the reference's nested boost::serialization TEXT archives (ref:
corbslam_client/src/DataDriver.cc:150-161 — every keyframe re-archived as
ASCII, the dominant uplink bandwidth cost per SURVEY.md §3.3; adapters in
include/SerializeObject.h) with a dtype-stable binary layout: a message is
a dict of named numpy arrays packed as [name, dtype, shape, raw bytes]
sections behind a fixed header. SoA arrays go on the wire exactly as they
sit in device memory — no per-object encoding, no text.

Entity identity crosses the wire as GLOBAL ids with the reference's
client-stride partitioning (gid = client * stride + local_row,
KeyFrame.cc:49-51); each receiving map keeps a host-side gid->row dict
(the Cache::lKFToKFmap equivalent, Cache.h:205-209).

A C++ codec (runtime/) can read/write this layout directly; this module is
the Python reference implementation.
"""

from __future__ import annotations

import struct
from typing import Dict

import numpy as np

MAGIC = b"CSW1"

# Service / topic names (the 4+4 schema of corbslam_insert.srv /
# PubToClient.cpp:17-20).
SRV_INSERT_KFS = "insertKeyFramesToMap"
SRV_INSERT_MPS = "insertMapPointsToMap"
SRV_UPDATE_KFS = "updateKeyFramePoses"
SRV_UPDATE_MPS = "updateMapPointPositions"
# Late-join / lost-message recovery: ask the server to replay the whole
# global map in chunks (the reference's resentGlobalMapToClient,
# MapFusion.cpp:370-423, exposed as a pull instead of an unconditional
# post-fusion push).
SRV_RESYNC = "requestMapResync"
TOPIC_NEW_KFS = "serverNewKeyFrames"
TOPIC_NEW_MPS = "serverNewMapPoints"
TOPIC_UPD_KFS = "serverUpdatedKeyFramePoses"
TOPIC_UPD_MPS = "serverUpdatedMapPointPositions"


def pack_arrays(d: Dict[str, np.ndarray]) -> bytes:
    """dict[str, ndarray] -> bytes. Deterministic little-endian layout:
    MAGIC | u32 n | n * (u16 name_len, name, 16s dtype, u8 ndim,
    ndim*u64 dims, u64 nbytes, raw)."""
    out = [MAGIC, struct.pack("<I", len(d))]
    for name, arr in d.items():
        # NOT ascontiguousarray: it silently promotes 0-d arrays to 1-d.
        arr = np.asarray(arr, order="C")
        nb = name.encode()
        dt = arr.dtype.str.encode().ljust(16, b"\0")
        out.append(struct.pack("<H", len(nb)))
        out.append(nb)
        out.append(dt)
        out.append(struct.pack("<B", arr.ndim))
        out.append(struct.pack(f"<{arr.ndim}Q", *arr.shape) if arr.ndim else b"")
        raw = arr.tobytes()
        out.append(struct.pack("<Q", len(raw)))
        out.append(raw)
    return b"".join(out)


def unpack_arrays(buf: bytes) -> Dict[str, np.ndarray]:
    assert buf[:4] == MAGIC, "bad wire magic"
    (n,) = struct.unpack_from("<I", buf, 4)
    off = 8
    out: Dict[str, np.ndarray] = {}
    for _ in range(n):
        (nlen,) = struct.unpack_from("<H", buf, off); off += 2
        name = buf[off:off + nlen].decode(); off += nlen
        dt = buf[off:off + 16].rstrip(b"\0").decode(); off += 16
        (ndim,) = struct.unpack_from("<B", buf, off); off += 1
        shape = struct.unpack_from(f"<{ndim}Q", buf, off) if ndim else ()
        off += 8 * ndim
        (nbytes,) = struct.unpack_from("<Q", buf, off); off += 8
        arr = np.frombuffer(buf[off:off + nbytes], dtype=np.dtype(dt))
        out[name] = arr.reshape(shape)
        off += nbytes
    return out


# ---------------------------------------------------------------------------
# Message builders (all fields are numpy arrays; gids are int64)
# ---------------------------------------------------------------------------

def kf_insert_msg(gid, client, Tcw, xy, octave, angle, desc, uright, depth,
                  fvalid, mp_gid, frame_id, timestamp) -> Dict[str, np.ndarray]:
    """Full keyframe payload — the reference ships the whole ~45-field
    KeyFrame on insert (KeyFrame.h:60-87); here it is exactly the SoA row."""
    return {
        "gid": np.asarray(gid, np.int64),
        "client": np.asarray(client, np.int32),
        "Tcw": np.asarray(Tcw, np.float32),
        "xy": np.asarray(xy, np.float32),
        "octave": np.asarray(octave, np.int32),
        "angle": np.asarray(angle, np.float32),
        "desc": np.asarray(desc, np.uint8),
        "uright": np.asarray(uright, np.float32),
        "depth": np.asarray(depth, np.float32),
        "fvalid": np.asarray(fvalid, bool),
        "mp_gid": np.asarray(mp_gid, np.int64),
        "frame_id": np.asarray(frame_id, np.int32),
        "timestamp": np.asarray(timestamp, np.float32),
    }


def mp_insert_msg(gid, client, pos, normal, desc, min_dist, max_dist,
                  ref_kf_gid) -> Dict[str, np.ndarray]:
    return {
        "gid": np.asarray(gid, np.int64),
        "client": np.asarray(client, np.int32),
        "pos": np.asarray(pos, np.float32),
        "normal": np.asarray(normal, np.float32),
        "desc": np.asarray(desc, np.uint8),
        "min_dist": np.asarray(min_dist, np.float32),
        "max_dist": np.asarray(max_dist, np.float32),
        "ref_kf_gid": np.asarray(ref_kf_gid, np.int64),
    }


def kf_pose_msg(gid, Tcw) -> Dict[str, np.ndarray]:
    """Compact pose delta (the reference's KeyFramePose, TransPose.h:27-49)."""
    return {"gid": np.asarray(gid, np.int64), "Tcw": np.asarray(Tcw, np.float32)}


def mp_pos_msg(gid, pos) -> Dict[str, np.ndarray]:
    """Compact position delta (MapPointPose, TransPose.h:51-68)."""
    return {"gid": np.asarray(gid, np.int64), "pos": np.asarray(pos, np.float32)}


def transm_msg(trans: Dict[int, tuple]) -> Dict[str, np.ndarray]:
    """Per-client alignment transforms riding every downlink message
    (the TRANSM map, PubToClient.cpp:48-52)."""
    cids = sorted(trans.keys())
    R = np.stack([np.asarray(trans[c][0], np.float32) for c in cids]) if cids \
        else np.zeros((0, 3, 3), np.float32)
    t = np.stack([np.asarray(trans[c][1], np.float32) for c in cids]) if cids \
        else np.zeros((0, 3), np.float32)
    s = np.asarray([float(trans[c][2]) for c in cids], np.float32)
    return {
        "transm_cid": np.asarray(cids, np.int32),
        "transm_R": R, "transm_t": t, "transm_s": s,
    }


def transm_lookup(msg: Dict[str, np.ndarray], cid: int):
    """Extract this client's alignment from a downlink message, or None."""
    cids = msg.get("transm_cid")
    if cids is None:
        return None
    hits = np.nonzero(cids == cid)[0]
    if len(hits) == 0:
        return None
    i = int(hits[0])
    return msg["transm_R"][i], msg["transm_t"][i], float(msg["transm_s"][i])
