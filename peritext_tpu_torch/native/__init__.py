"""The port's native host runtime: a C++ wire parser and schedulers.

``src/native.cpp`` (the package's own copy of the reference package's
native source) compiles with ``g++ -O2 -std=c++17 -shared -fPIC`` at first
use, never at import, into the git-ignored ``peritext_tpu_torch/_build/``
as ``libptnative-<hash>.so``, keyed by the source and the flags (as
``utils/nvcc.py`` keys the CUDA builds), and is bound with ``ctypes``
through a plain C ABI.  Set ``PERITEXT_TORCH_NO_NATIVE=1`` to force the
pure-Python fallbacks: every entry point but the scalar baseline
(:func:`scalar_apply`, which raises) has one, and both give the same
arrays.  This is host code; the card is not involved.

``calls`` counts the native calls made per entry point, so a run can show
that the library, and not a fallback, served it.  The build and the load
each log one record on the ``peritext_tpu_torch.kernels`` logger, which
``obs.RecompileSentinel`` counts.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_SRC = Path(__file__).parent / "src" / "native.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: build and load records, as utils/nvcc.py logs them (obs/sentinel.py)
_log = logging.getLogger("peritext_tpu_torch.kernels")
_tried = False

#: native calls per entry point (``causal_schedule``, ``parse_frames``,
#: ``parse_changes``, ``schedule_split_batch``, ``scalar_apply``,
#: ``varint_encode``, ``varint_decode``)
calls: Dict[str, int] = {}


def _count(name: str) -> None:
    calls[name] = calls.get(name, 0) + 1


def library_path() -> Path:
    """Where the source builds to, keyed by the source and the flags."""
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join(_FLAGS).encode())
    return _BUILD_DIR / f"libptnative-{digest.hexdigest()[:16]}.so"


def _compile() -> Optional[Path]:
    out = library_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Unique tmp name per process: concurrent first-use builds (pytest
    # workers, shared FS) must not interleave writes before the atomic
    # rename installs the hash-keyed artifact.
    tmp = out.with_name(f".{out.stem}.{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    _log.info("Building native with g++ into %s", out.name)
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        tmp.unlink(missing_ok=True)
    return out


def load() -> Optional[ctypes.CDLL]:
    """The native library, or None when unavailable/disabled."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("PERITEXT_TORCH_NO_NATIVE") == "1":
            return None
        path = _compile()
        if path is None:
            return None
        _log.info("Loading native from %s", path.name)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.pt_causal_schedule.restype = ctypes.c_int32
        lib.pt_causal_schedule.argtypes = [
            ctypes.c_int32, i32p, i32p, i32p, i32p, i32p,
            ctypes.c_int32, i32p, i32p,
        ]
        lib.pt_varint_encode.restype = ctypes.c_int64
        lib.pt_varint_encode.argtypes = [i32p, ctypes.c_int64, u8p, ctypes.c_int64]
        lib.pt_varint_decode.restype = ctypes.c_int64
        lib.pt_varint_decode.argtypes = [u8p, ctypes.c_int64, i32p, ctypes.c_int64]
        lib.pt_parse_changes.restype = ctypes.c_int32
        lib.pt_parse_changes.argtypes = [
            i32p, ctypes.c_int64, ctypes.c_int32,  # vals, n_vals, n_changes
            i32p, ctypes.c_int32,  # str2actor, n_strings
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # actor_bits, max_ctr, version
            i32p, i32p,  # ch_actor, ch_seq
            i32p, i32p, i32p, ctypes.c_int64,  # dep_off, dep_actor, dep_seq, dep_cap
            i32p, i32p, ctypes.c_int64,  # ops_off, ops, op_cap
            i32p, i32p, i32p, i32p,  # cnt_ins, cnt_del, cnt_mark, cnt_map
        ]
        lib.pt_schedule_split_batch.restype = ctypes.c_int32
        lib.pt_schedule_split_batch.argtypes = (
            [ctypes.c_int32, ctypes.c_int32]  # n_docs, n_actors
            + [i32p] * 3  # ch_off, doc_row, text_obj
            + [i32p] * 2  # ch_actor, ch_seq
            + [i32p] * 3  # dep_off, dep_actor, dep_seq
            + [i32p] * 2  # ops_off, ops
            + [i32p]  # clock
            + [ctypes.c_int32] * 4  # ki, kd, km, kp
            + [i32p] * 12  # ins x3, del, marks x8
            + [i32p] * 5  # map stream x5
            + [i32p] * 5  # n_ins, n_del, n_mark, n_map, n_admitted
            + [u8p] * 2  # admitted, status
        )
        lib.pt_scalar_apply.restype = ctypes.c_int64
        lib.pt_scalar_apply.argtypes = [
            i32p, ctypes.c_int64,  # ops, n_ops
            i32p, ctypes.c_int64,  # out_text, out_cap
            i64p, i64p,  # out_visible, out_check
        ]
        lib.pt_parse_frames.restype = ctypes.c_int32
        lib.pt_parse_frames.argtypes = [
            u8p, i64p, ctypes.c_int32,  # data, frame_off, n_frames
            u8p, i64p, ctypes.c_int32,  # actor_bytes, actor_off, n_actors
            ctypes.c_int32, ctypes.c_int32,  # actor_bits, max_ctr
            i32p, i32p, i32p,  # f_status, f_ch_off, f_str_off
            i64p, i32p, ctypes.c_int64,  # str_start, str_len, str_cap
            i32p, i32p, ctypes.c_int64,  # ch_actor, ch_seq, ch_cap
            i32p, i32p, i32p, ctypes.c_int64,  # dep_off, dep_actor, dep_seq, dep_cap
            i32p, i32p, ctypes.c_int64,  # ops_off, ops, op_cap
            i32p, i32p, i32p, i32p,  # cnt_ins, cnt_del, cnt_mark, cnt_map
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def causal_schedule_indices(
    actor: np.ndarray,
    seq: np.ndarray,
    dep_off: np.ndarray,
    dep_actor: np.ndarray,
    dep_seq: np.ndarray,
    n_actors: int,
    base_clock: np.ndarray,
) -> Optional[np.ndarray]:
    """Native schedule; returns ordered change indices or None if no native."""
    lib = load()
    if lib is None:
        return None
    _count("causal_schedule")
    n = int(actor.shape[0])
    out = np.empty(n, np.int32)
    count = lib.pt_causal_schedule(
        n,
        np.ascontiguousarray(actor, np.int32),
        np.ascontiguousarray(seq, np.int32),
        np.ascontiguousarray(dep_off, np.int32),
        np.ascontiguousarray(dep_actor, np.int32),
        np.ascontiguousarray(dep_seq, np.int32),
        int(n_actors),
        np.ascontiguousarray(base_clock, np.int32),
        out,
    )
    return out[:count]


def _grow_capacities(call, dep_cap: int, op_cap: int, attempts: int = 12) -> int:
    """Run ``call(dep_cap, op_cap)`` (which allocates its outputs and returns
    the native rc), doubling whichever capacity the parser reports exhausted
    (-2 deps, -3 ops).  Wire-v2 elided headers emit dep entries from ZERO
    payload ints, so output sizes are no longer payload-bounded and a fixed
    cap can legitimately fall short.  Raises on exhaustion — a capacity
    condition, distinct from frame corruption."""
    rc = None
    for _ in range(attempts):
        rc = call(dep_cap, op_cap)
        if rc == -2:
            dep_cap *= 2
        elif rc == -3:
            op_cap *= 2
        else:
            return rc
    raise RuntimeError(
        f"native parse output capacity exhausted after {attempts} growth "
        f"attempts (rc={rc})"
    )


def parse_changes(
    values: np.ndarray,
    n_changes: int,
    str2actor: np.ndarray,
    actor_bits: int,
    max_ctr: int,
    version: int = 1,
):
    """Native frame-payload parse (see pt_parse_changes in native.cpp).

    Returns ``(ch_actor, ch_seq, dep_off, dep_actor, dep_seq, ops_off, ops,
    cnt_ins, cnt_del, cnt_mark, cnt_map)`` with ``ops`` shaped (n_ops, 10),
    or None when the native library is unavailable.  Raises ValueError on a
    malformed payload.
    """
    lib = load()
    if lib is None:
        return None
    _count("parse_changes")
    values = np.ascontiguousarray(values, np.int32)
    str2actor = np.ascontiguousarray(str2actor, np.int32)
    n = int(n_changes)
    # v2 elided headers can emit dep entries from zero wire ints (see
    # parse_frames): start from an estimate and grow on capacity returns
    dep_cap = int(values.size) // 2 + 1 + 4 * (n + 1)
    op_cap = int(values.size) // 2 + 1
    ch_actor = np.empty(n, np.int32)
    ch_seq = np.empty(n, np.int32)
    dep_off = np.empty(n + 1, np.int32)
    ops_off = np.empty(n + 1, np.int32)
    cnt_ins = np.empty(n, np.int32)
    cnt_del = np.empty(n, np.int32)
    cnt_mark = np.empty(n, np.int32)
    cnt_map = np.empty(n, np.int32)
    out = {}

    def call(dc, oc):
        out["dep_actor"] = np.empty(dc, np.int32)
        out["dep_seq"] = np.empty(dc, np.int32)
        out["ops"] = np.empty((oc, 10), np.int32)
        return lib.pt_parse_changes(
            values, int(values.size), n,
            str2actor, int(str2actor.size),
            int(actor_bits), int(max_ctr), int(version),
            ch_actor, ch_seq,
            dep_off, out["dep_actor"], out["dep_seq"], dc,
            ops_off, out["ops"].reshape(-1), oc,
            cnt_ins, cnt_del, cnt_mark, cnt_map,
        )

    rc = _grow_capacities(call, dep_cap, op_cap)
    dep_actor, dep_seq, ops = out["dep_actor"], out["dep_seq"], out["ops"]
    if rc != 0:
        raise ValueError(f"malformed change frame payload (native rc={rc})")
    n_deps = int(dep_off[n])
    n_ops = int(ops_off[n])
    return (
        ch_actor, ch_seq,
        dep_off, dep_actor[:n_deps].copy(), dep_seq[:n_deps].copy(),
        ops_off, ops[:n_ops].copy(),
        cnt_ins, cnt_del, cnt_mark, cnt_map,
    )


def parse_frames(
    data: np.ndarray,  # concatenated frame bytes, uint8
    frame_off: np.ndarray,  # (F+1,) int64 byte offsets
    header_counts,  # (n_changes_total, n_strings_total, n_ints_total) from headers
    actor_strings,  # declared actor names in interner order (index i -> id i+1)
    actor_bits: int,
    max_ctr: int,
):
    """Bulk whole-frame parse (see pt_parse_frames in native.cpp).

    Returns ``(f_status, f_ch_off, f_str_off, str_start, str_len, ch_actor,
    ch_seq, dep_off, dep_actor, dep_seq, ops_off, ops, cnt_ins, cnt_del,
    cnt_mark, cnt_map)`` with all change/dep/op arrays flattened across
    frames and trimmed to their true lengths, or None when no native
    library.  Corrupt frames are reported per frame via ``f_status`` (1),
    never an exception.
    """
    lib = load()
    if lib is None:
        return None
    _count("parse_frames")
    n_frames = int(frame_off.shape[0]) - 1
    ch_total, str_total, ints_total = (int(x) for x in header_counts)
    raw = [s.encode("utf-8") for s in actor_strings]
    actor_bytes = np.frombuffer(b"".join(raw) or b"\x00", np.uint8)
    actor_off = np.concatenate(
        [[0], np.cumsum([len(r) for r in raw], dtype=np.int64)]
    ).astype(np.int64)

    # v2 DEPS_SAME / elided-own-dep headers emit dep entries from ZERO wire
    # ints, so dep output is no longer bounded by the payload size — start
    # from a realistic estimate and grow on a capacity return.
    dep_cap = ints_total // 2 + 2 + 4 * (ch_total + 1)
    op_cap = ints_total // 2 + 2
    str_cap = str_total + 1
    f_status = np.empty(n_frames, np.int32)
    f_ch_off = np.empty(n_frames + 1, np.int32)
    f_str_off = np.empty(n_frames + 1, np.int32)
    str_start = np.empty(str_cap, np.int64)
    str_len = np.empty(str_cap, np.int32)
    ch_actor = np.empty(ch_total + 1, np.int32)
    ch_seq = np.empty(ch_total + 1, np.int32)
    dep_off = np.empty(ch_total + 2, np.int32)
    ops_off = np.empty(ch_total + 2, np.int32)
    cnt_ins = np.empty(ch_total + 1, np.int32)
    cnt_del = np.empty(ch_total + 1, np.int32)
    cnt_mark = np.empty(ch_total + 1, np.int32)
    cnt_map = np.empty(ch_total + 1, np.int32)

    out = {}

    def call(dc, oc):
        out["dep_actor"] = np.empty(dc, np.int32)
        out["dep_seq"] = np.empty(dc, np.int32)
        out["ops"] = np.empty((oc, 10), np.int32)
        return lib.pt_parse_frames(
            np.ascontiguousarray(data), np.ascontiguousarray(frame_off, np.int64),
            n_frames,
            np.ascontiguousarray(actor_bytes), actor_off, len(raw),
            int(actor_bits), int(max_ctr),
            f_status, f_ch_off, f_str_off,
            str_start, str_len, str_cap,
            ch_actor, ch_seq, ch_total + 1,
            dep_off, out["dep_actor"], out["dep_seq"], dc,
            ops_off, out["ops"].reshape(-1), oc,
            cnt_ins, cnt_del, cnt_mark, cnt_map,
        )

    rc = _grow_capacities(call, dep_cap, op_cap)
    dep_actor, dep_seq, ops = out["dep_actor"], out["dep_seq"], out["ops"]
    if rc != 0:  # non-capacity rc: sizing bug — surface loudly, don't mis-parse
        raise RuntimeError(f"pt_parse_frames capacity error rc={rc}")
    nc = int(f_ch_off[n_frames])
    ns = int(f_str_off[n_frames])
    n_deps = int(dep_off[nc]) if nc else 0
    n_ops = int(ops_off[nc]) if nc else 0
    return (
        f_status, f_ch_off, f_str_off,
        str_start[:ns], str_len[:ns],
        ch_actor[:nc], ch_seq[:nc],
        dep_off[: nc + 1], dep_actor[:n_deps].copy(), dep_seq[:n_deps].copy(),
        ops_off[: nc + 1], ops[:n_ops].copy(),
        cnt_ins[:nc], cnt_del[:nc], cnt_mark[:nc], cnt_map[:nc],
    )


def schedule_split_batch(
    n_actors: int,
    ch_off: np.ndarray,
    doc_row: np.ndarray,
    text_obj: np.ndarray,
    parsed_cols,  # (ch_actor, ch_seq, dep_off, dep_actor, dep_seq, ops_off, ops)
    clock: np.ndarray,  # (n_docs, n_actors) int32, updated in place
    caps,  # (ki, kd, km, kp)
    ins_arrays,  # (ins_ref, ins_op, ins_char) each (D, ki) int32
    del_array: np.ndarray,  # (D, kd)
    mark_arrays,  # dict of 8 (D, km) arrays in MARK_COLS order
    map_arrays,  # dict of 5 (D, kp) arrays in MAP_STREAM_COLS order
):
    """One-call round scheduling for every frame-mode doc (see
    pt_schedule_split_batch).  Returns ``(total, n_ins, n_del, n_mark,
    n_map, n_admitted, admitted, status)`` or None when no native library."""
    lib = load()
    if lib is None:
        return None
    _count("schedule_split_batch")
    n_docs = int(ch_off.shape[0]) - 1
    ch_actor, ch_seq, dep_off, dep_actor, dep_seq, ops_off, ops = parsed_cols
    n_changes = int(ch_actor.shape[0])
    n_ins = np.zeros(n_docs, np.int32)
    n_del = np.zeros(n_docs, np.int32)
    n_mark = np.zeros(n_docs, np.int32)
    n_map = np.zeros(n_docs, np.int32)
    n_admitted = np.zeros(n_docs, np.int32)
    admitted = np.zeros(n_changes, np.uint8)
    status = np.zeros(n_docs, np.uint8)
    c = lambda a: np.ascontiguousarray(a, np.int32)  # noqa: E731
    total = lib.pt_schedule_split_batch(
        n_docs, int(n_actors),
        c(ch_off), c(doc_row), c(text_obj),
        c(ch_actor), c(ch_seq),
        c(dep_off), c(dep_actor), c(dep_seq),
        c(ops_off), c(ops).reshape(-1),
        clock,
        int(caps[0]), int(caps[1]), int(caps[2]), int(caps[3]),
        ins_arrays[0], ins_arrays[1], ins_arrays[2],
        del_array,
        mark_arrays["m_action"], mark_arrays["m_type"],
        mark_arrays["m_start_kind"], mark_arrays["m_start_elem"],
        mark_arrays["m_end_kind"], mark_arrays["m_end_elem"],
        mark_arrays["m_op"], mark_arrays["m_attr"],
        map_arrays["p_obj"], map_arrays["p_key"], map_arrays["p_op"],
        map_arrays["p_kind"], map_arrays["p_val"],
        n_ins, n_del, n_mark, n_map, n_admitted,
        admitted, status,
    )
    return total, n_ins, n_del, n_mark, n_map, n_admitted, admitted, status


def scalar_apply(ops: np.ndarray):
    """Single-core scalar baseline apply (see pt_scalar_apply): ``ops`` is
    the (N, 10) parsed op matrix in causal application order.  Returns
    ``(applied, visible_codepoints)``.  Unlike the other entry points it has
    no Python fallback: it is the baseline a device rate is held against,
    so a missing library raises (RuntimeError) instead of returning None."""
    lib = load()
    if lib is None:
        raise RuntimeError("the native host library is unavailable: the scalar baseline "
                           "runs only on it (PERITEXT_TORCH_NO_NATIVE unset, g++ present)")
    _count("scalar_apply")
    ops = np.ascontiguousarray(ops, np.int32)
    cap = int(ops.shape[0]) + 8
    out_text = np.empty(cap, np.int32)
    out_visible = np.zeros(1, np.int64)
    out_check = np.zeros(1, np.int64)
    applied = lib.pt_scalar_apply(
        ops.reshape(-1), int(ops.shape[0]), out_text, cap, out_visible, out_check
    )
    return int(applied), out_text[: int(out_visible[0])].copy()


def varint_encode(values: np.ndarray) -> Optional[bytes]:
    lib = load()
    if lib is None:
        return None
    _count("varint_encode")
    values = np.ascontiguousarray(values, np.int32)
    cap = int(values.size) * 5 + 16
    out = np.empty(cap, np.uint8)
    written = lib.pt_varint_encode(values, int(values.size), out, cap)
    if written < 0:
        raise ValueError("varint encode overflow")
    return out[:written].tobytes()


def varint_decode(data: bytes, expected: int) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    _count("varint_decode")
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(expected, np.int32)
    count = lib.pt_varint_decode(
        np.ascontiguousarray(buf), int(buf.size), out, expected
    )
    if count < 0 or count != expected:
        raise ValueError("malformed varint payload")
    return out
