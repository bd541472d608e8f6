"""The port's convergence digests (peritext_tpu_torch/parallel/mesh.py)
against the reference package's (peritext_tpu/parallel/mesh.py), exactly,
on seeded numpy inputs: words at 2**32 - 1, comment words with bit 31 set,
ids past the end of a hash table (the clip).  And the host mirrors against
the device functions on docs built from known marks and registers.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from peritext_tpu.parallel import mesh as ref
from peritext_tpu_torch.parallel import mesh
from peritext_tpu_torch.schema import ALL_MARKS
from peritext_tpu_torch.utils.interning import Interner, content_hash32

COMMENT_TYPE = ALL_MARKS.index("comment")
LINK_TYPE = ALL_MARKS.index("link")
M32 = 0xFFFFFFFF


def _u32_words(rng, shape):
    """uint32 words with the extremes forced in: 0, 1, 2**31, 2**32 - 1."""
    w = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
    flat = w.reshape(-1)
    flat[:4] = [0, 1, 1 << 31, M32]
    return w


def _i32(rng, shape, lo=-(1 << 31), hi=1 << 31):
    a = rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)
    a.reshape(-1)[:2] = [-1, (1 << 31) - 1]
    return a


def _t(a):
    """numpy -> torch, uint32 words as int64."""
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a)


def _as_int(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mul32_matches_python(seed):
    rng = np.random.default_rng(seed)
    x = _u32_words(rng, (64,)).astype(np.int64)
    for k in (mesh._KC1, mesh._KP, mesh._KF, mesh._KV, M32, 0, 1):
        got = mesh._mul32(torch.from_numpy(x), k).numpy()
        assert got.tolist() == [(int(v) * k) & M32 for v in x]
        assert got.max() <= M32


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_text_digest_and_convergence_digest(seed):
    rng = np.random.default_rng(seed)
    d, s = 6, 40
    chars = _i32(rng, (d, s))
    visible = rng.random((d, s)) < 0.6
    mask = rng.random(d) < 0.5
    want = np.asarray(ref.per_doc_text_digest(jnp.asarray(chars), jnp.asarray(visible)))
    got = mesh.per_doc_text_digest(_t(chars), _t(visible)).numpy()
    assert got.tolist() == want.astype(np.int64).tolist()
    for m in (None, mask):
        want = ref.convergence_digest(jnp.asarray(chars), jnp.asarray(visible),
                                      None if m is None else jnp.asarray(m))
        got = mesh.convergence_digest(_t(chars), _t(visible), None if m is None else _t(m))
        assert int(got) == int(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("comment_ids", [32, 40])
def test_format_digest(seed, comment_ids):
    rng = np.random.default_rng(seed)
    d, s, a = 5, 33, 8
    words = -(-comment_ids // 32)
    visible = rng.random((d, s)) < 0.7
    lww = rng.random((d, len(ALL_MARKS), s)) < 0.4
    # link ids in and past the table (the clip), some negative
    link_attr = rng.integers(-2, a + 5, size=(d, s)).astype(np.int32)
    bits = _u32_words(rng, (d, words, s))
    bits[:, :, 0] |= np.uint32(1 << 31)  # bit 31 set
    attr_hash = _u32_words(rng, (d, a))
    comment_hash = _u32_words(rng, (d, comment_ids))
    want = ref.per_doc_format_digest(
        jnp.asarray(visible), jnp.asarray(lww), jnp.asarray(link_attr), jnp.asarray(bits),
        jnp.asarray(attr_hash), jnp.asarray(comment_hash), COMMENT_TYPE, LINK_TYPE,
    )
    got = mesh.per_doc_format_digest(
        _t(visible), _t(lww), _t(link_attr), _t(bits), _t(attr_hash), _t(comment_hash),
        COMMENT_TYPE, LINK_TYPE,
    )
    assert got.numpy().tolist() == _as_int(want).tolist()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_register_digest(seed):
    rng = np.random.default_rng(seed)
    d, r, k = 5, 12, 8
    r_obj = _i32(rng, (d, r))
    r_key = rng.integers(-1, k + 4, size=(d, r)).astype(np.int32)  # past the table
    r_op = rng.integers(0, 3, size=(d, r)).astype(np.int32)
    r_kind = rng.integers(0, 8, size=(d, r)).astype(np.int32)
    r_val = _i32(rng, (d, r))
    r_val[:, ::3] = rng.integers(-1, k + 4, size=r_val[:, ::3].shape)  # string ids
    key_hash = _u32_words(rng, (d, k))
    want = ref.per_doc_register_digest(*(jnp.asarray(x) for x in (
        r_obj, r_key, r_op, r_kind, r_val, key_hash)), 0, 1)
    got = mesh.per_doc_register_digest(*(_t(x) for x in (
        r_obj, r_key, r_op, r_kind, r_val, key_hash)), 0, 1)
    assert got.numpy().tolist() == _as_int(want).tolist()


def _random_marks(rng, n, urls, comments):
    out = []
    for _ in range(n):
        marks = {}
        for name in ("strong", "em"):
            if rng.random() < 0.4:
                marks[name] = {"active": True}
        if rng.random() < 0.4:
            marks["link"] = {"active": True, "url": urls[rng.integers(len(urls))]}
        ids = sorted({comments[i] for i in rng.integers(0, len(comments), rng.integers(0, 3))})
        if ids:
            marks["comment"] = [{"id": c} for c in ids]
        out.append(marks)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_mirrors_equal_reference_and_device(seed):
    rng = np.random.default_rng(seed)
    s = 48
    slots = sorted(rng.choice(s, size=20, replace=False).tolist())
    cps = rng.integers(32, 0x10FFFF, size=len(slots)).tolist()
    urls = ["", "https://a.example", "https://b.example"]
    comments = [f"c{i}" for i in range(40)]
    marks = _random_marks(rng, len(slots), urls, comments)

    # host mirrors: the port's equal the reference's
    assert mesh.doc_digest_host(cps, slots, s) == ref.doc_digest_host(cps, slots, s)
    fmt = mesh.format_digest_host(slots, marks, ALL_MARKS, COMMENT_TYPE)
    assert fmt == ref.format_digest_host(slots, marks, ALL_MARKS, COMMENT_TYPE)
    rows = [(int(o), content_hash32(f"k{j}"), int(kind), int(v)) for j, (o, kind, v) in
            enumerate(zip(_u32_words(rng, (9,)), rng.integers(1, 8, 9), _u32_words(rng, (9,))))]
    assert mesh.register_digest_host(rows) == ref.register_digest_host(rows)

    # the device text digest of one doc equals its host mirror
    chars = np.zeros((1, s), np.int32)
    visible = np.zeros((1, s), bool)
    chars[0, slots] = cps
    visible[0, slots] = True
    assert int(mesh.per_doc_text_digest(_t(chars), _t(visible))[0]) == \
        mesh.doc_digest_host(cps, slots, s)

    # the device format digest of one doc equals its host mirror
    attrs, cids = Interner(), Interner()
    lww = np.zeros((1, len(ALL_MARKS), s), bool)
    link = np.zeros((1, s), np.int32)
    bits = np.zeros((1, 2, s), np.int64)
    for slot, m in zip(slots, marks):
        for name in ("strong", "em", "link"):
            lww[0, ALL_MARKS.index(name), slot] = name in m
        if "link" in m:
            link[0, slot] = attrs.intern(m["link"]["url"])
        for c in m.get("comment", []):
            i = cids.intern(c["id"])
            bits[0, i // 32, slot] |= 1 << (i % 32)
    attr_hash = np.zeros((1, 8), np.uint32)
    attr_hash[0, : len(attrs)] = attrs.content_hashes()
    comment_hash = np.zeros((1, 64), np.uint32)
    comment_hash[0, : len(cids)] = cids.content_hashes()
    got = mesh.per_doc_format_digest(_t(visible), _t(lww), _t(link), torch.from_numpy(bits),
                                     _t(attr_hash), _t(comment_hash), COMMENT_TYPE, LINK_TYPE)
    assert int(got[0]) == fmt

    # the device register digest of one doc equals its host mirror
    keys = Interner([f"k{j}" for j in range(9)] + ["sval"])
    key_hash = np.zeros((1, 16), np.uint32)
    key_hash[0, : len(keys)] = keys.content_hashes()
    r_obj = np.asarray([[o for o, _, _, _ in rows] + [7]], np.uint32).view(np.int32)
    r_key = np.asarray([[keys.get(f"k{j}") for j in range(9)] + [1]], np.int32)
    r_kind = np.asarray([[kind for _, _, kind, _ in rows] + [0]], np.int32)  # + a deleted key
    r_val = np.asarray([[v for _, _, _, v in rows] + [5]], np.uint32).view(np.int32)
    str_rows = r_kind[0] == 1
    r_val[0, str_rows] = keys.get("sval")
    host_rows = [(o, k, kind, content_hash32("sval") if kind == 1 else v)
                 for o, k, kind, v in rows]
    r_op = np.ones_like(r_key)
    got = mesh.per_doc_register_digest(*(_t(x) for x in (r_obj, r_key, r_op, r_kind, r_val,
                                                          key_hash)), 0, 1)
    assert int(got[0]) == mesh.register_digest_host(host_rows)
