"""Port parity: BLAKE2b level hashing and the device tokenizer.

``bifromq_tpu_torch.ops.tokenize._hash_lanes`` (the plain version of
``csrc/blake2b_levels.cu``, and what ``blake2b_levels`` runs on CPU
tensors) must be bit-exact with the reference's ``automaton.level_hash``,
its ``hash_topics_device(impl="lax")`` leg and its byte plane
(``bytetok.tokenize_bytes``). The lax leg runs op by op under
``jax.disable_jit()``: compiled, its unrolled 12-round graph takes minutes
on the CPU, and so does the interpreted Pallas kernel, whose body is the
same ``_hash_lanes`` (the reference's own parity suite holds the Pallas
leg equal to the lax leg). Tolerance: exact equality — every output is
int32 or bool. The topics are adversarial: empty levels, a 128-byte
level, a level over one block (a padding row), rows past the byte
budget, multi-byte UTF-8 and ``$SYS``.
"""

import random

import jax
import numpy as np
import pytest
import torch

from bifromq_tpu.models import bytetok as jbt
from bifromq_tpu.models.automaton import level_hash
from bifromq_tpu.ops import tokenize as jtok
from bifromq_tpu_torch.models import automaton as ta
from bifromq_tpu_torch.models.bytetok import TopicBytes
from bifromq_tpu_torch.ops import tokenize as ttok
from bifromq_tpu_torch import workloads as tw


def _adversarial(n=64, seed=0):
    rng = random.Random(seed)
    segs = ["a", "bb", "sensor", "température", "日本語", "датчик", "",
            "x" * 40, "d" * 127, "$SYS", "$share", "0"]
    fixed = ["", "/", "//", "a//b", "trailing/", "/leading",
             "$SYS/health/cpu", "$share/g/t", "é" * 64, "q" * 128,
             "x" * 129, "y" * 300 + "/z", "a/" * 20 + "tail"]
    out = list(fixed)
    for _ in range(n - len(fixed)):
        out.append("/".join(rng.choice(segs)
                            for _ in range(rng.randint(1, 8))))
    return out


def _port_tokenize(topics, salt, batch, max_levels=16):
    return ttok.device_tokenize(TopicBytes.from_topics(topics),
                                list(range(len(topics))),
                                max_levels=max_levels, salt=salt,
                                batch=batch, device="cpu")


@pytest.mark.parametrize("salt", [0, 7, 987654321])
def test_plain_hash_equals_level_hash(salt):
    topics = _adversarial(seed=salt)
    mirror, probes = _port_tokenize(topics, salt, 64)
    h1, h2 = probes.tok_h1.numpy(), probes.tok_h2.numpy()
    for i, t in enumerate(topics):
        levels = t.split("/")
        if mirror.lengths[i] < 0:
            assert (h1[i] == 0).all() and (h2[i] == 0).all()
            continue
        assert mirror.lengths[i] == len(levels)
        assert mirror.sys_mask[i] == t.startswith("$")
        for j, lvl in enumerate(levels):
            assert (h1[i, j], h2[i, j]) == level_hash(lvl, salt), (t, j)
        assert (h1[i, len(levels):] == 0).all()
    # the 128-byte level hashes, the 129-byte one pads the row
    assert mirror.lengths[topics.index("q" * 128)] == 1
    assert mirror.lengths[topics.index("x" * 129)] == -1


@pytest.mark.parametrize("salt", [1, 3])
def test_plain_hash_equals_reference_byte_plane(salt):
    topics = tw.diverse_topics(96, seed=salt)
    ref = jbt.tokenize_bytes(jbt.TopicBytes.from_topics(topics),
                             [0] * 96, max_levels=16, salt=salt, batch=128)
    mirror, probes = _port_tokenize(topics, salt, 128)
    ok = mirror.lengths >= 0
    assert (ref[2][ok] == mirror.lengths[ok]).all()
    assert (ref[0][ok] == probes.tok_h1.numpy()[ok]).all()
    assert (ref[1][ok] == probes.tok_h2.numpy()[ok]).all()
    assert (ref[4][ok] == mirror.sys_mask[ok]).all()


def test_plain_hash_equals_reference_lax_leg():
    topics = _adversarial(n=32, seed=5)
    roots = list(range(len(topics)))
    with jax.disable_jit():
        ref_mirror, ref = jtok.device_tokenize(
            jbt.TopicBytes.from_topics(topics), roots, max_levels=16,
            salt=5, batch=32, impl="lax")
        ref_h1, ref_h2 = np.asarray(ref.tok_h1), np.asarray(ref.tok_h2)
    mirror, probes = _port_tokenize(topics, 5, 32)
    assert (ref_mirror.lengths == mirror.lengths).all()
    assert (ref_mirror.sys_mask == mirror.sys_mask).all()
    assert (ref_h1 == probes.tok_h1.numpy()).all()
    assert (ref_h2 == probes.tok_h2.numpy()).all()
    assert (mirror.lengths >= 0).sum() > 20 and (mirror.lengths < 0).any()


def test_wrapper_on_cpu_is_the_plain_version():
    topics = _adversarial(n=16, seed=2)
    lengths, _, _, rows, starts, lens = ttok.pack_topic_bytes(
        TopicBytes.from_topics(topics), [0] * 16, max_levels=16, batch=16)
    args = [torch.from_numpy(a) for a in (rows, starts, lens,
                                          lengths.reshape(16, 1))]
    args.append(ttok.h0_tensor(9, "cpu"))
    a = ttok.blake2b_levels(*args)
    b = ttok._hash_lanes(*args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_sub_batch_retokenizes_rows():
    topics = ["a/b", "$SYS/x", "c//d", "e"]
    mirror, probes = _port_tokenize(topics, 4, 16)
    sub = mirror.sub_batch(np.array([1, 2]), 4)
    host = ta.tokenize(["$SYS/x", "c//d"], [1, 2], max_levels=16, salt=4,
                       batch=4)
    for f in ("tok_h1", "tok_h2", "lengths", "roots", "sys_mask"):
        assert (getattr(sub, f) == getattr(host, f)).all(), f
    assert (sub.tok_h1[:2] == probes.tok_h1.numpy()[1:3]).all()


# ---- the level hash's edge cases, as the card's check feeds them -----------

@pytest.mark.parametrize("salt", [0, 11])
def test_hash_edge_topics_equal_level_hash(salt):
    """``workloads.hash_edge_topics`` (a 128-byte level, empty levels, a
    row at ``max_levels``, a level ending on the row's last byte, padding
    rows, ``$`` topics) through ``_hash_lanes`` equals ``level_hash`` level
    by level and the reference byte plane row by row."""
    max_levels, mb = 16, ttok.tok_max_bytes()
    topics = tw.hash_edge_topics(80, max_levels=max_levels, max_bytes=mb,
                                 seed=salt)
    mirror, probes = _port_tokenize(topics, salt, 96, max_levels=max_levels)
    h1, h2 = probes.tok_h1.numpy(), probes.tok_h2.numpy()
    for i, t in enumerate(topics):
        levels = t.split("/")
        if mirror.lengths[i] < 0:
            assert (h1[i] == 0).all() and (h2[i] == 0).all()
            continue
        assert mirror.lengths[i] == len(levels)
        assert mirror.sys_mask[i] == t.startswith("$")
        for j, lvl in enumerate(levels):
            assert (h1[i, j], h2[i, j]) == level_hash(lvl, salt), (t, j)
        assert (h1[i, len(levels):] == 0).all()
    assert (h1[80:] == 0).all() and (mirror.lengths[80:] == -1).all()
    ref = jbt.tokenize_bytes(jbt.TopicBytes.from_topics(topics), [0] * 80,
                             max_levels=max_levels, salt=salt, batch=96)
    ok = mirror.lengths >= 0    # the host plane also hashes the padded rows
    assert (ref[2][ok] == mirror.lengths[ok]).all()
    assert (ref[0][ok] == h1[ok]).all() and (ref[1][ok] == h2[ok]).all()
    # each edge the batch promises is there, hashed or padded as it should
    by_topic = dict(zip(topics, mirror.lengths))
    assert by_topic["q" * 128 + "/a"] == 2
    assert by_topic["z" * 129] == -1
    assert by_topic["a//b"] == 3
    assert by_topic["/".join(["l"] * max_levels)] == max_levels
    assert by_topic["/".join(["l"] * (max_levels + 1))] == -1
    assert by_topic["p" * (mb + 1)] == -1
    last = [t for t in topics if len(t.encode()) == mb and t.endswith("y")]
    assert last and by_topic[last[0]] > 0
    assert mirror.sys_mask[topics.index("$SYS/health/cpu")]


def test_plain_hash_clamps_like_reference():
    """Level boundaries outside the row (starts below 0 or past the row,
    lengths past the row's end, negative lengths) clamp each byte position
    to the row's ends in the reference's lax leg; ``_hash_lanes``, which
    the card's kernel is held to on the same kind of input, agrees."""
    rng = np.random.default_rng(4)
    b, mb, w = 6, 64, 5
    rows = rng.integers(0, 256, (b, mb)).astype(np.uint8)
    starts = rng.integers(-9, mb + 9, (b, w)).astype(np.int32)
    lens = rng.integers(-3, 141, (b, w)).astype(np.int32)
    nlv = np.array([[5], [3], [0], [-1], [5], [2]], dtype=np.int32)
    h0 = jbt.blake2b8_h0(13)
    with jax.disable_jit():
        ref = jtok._hash_lanes(
            rows, starts, lens, nlv,
            (h0 & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(1, 8),
            (h0 >> np.uint64(32)).astype(np.uint32).reshape(1, 8))
        ref = [np.asarray(x) for x in ref]
    got = ttok._hash_lanes(*(torch.from_numpy(a) for a in
                             (rows, starts, lens, nlv)),
                           ttok.h0_tensor(13, "cpu"))
    assert all((g.numpy() == r).all() for g, r in zip(got, ref))
    assert (ref[0][:2] != 0).any()
