"""The port's synthetic token pipeline against the JAX package's.

``host_batch`` is numpy alone in both packages (counter-based Philox keyed
by seed, step and absolute row), and the port keeps its own copy: the two
must give the same tokens and targets bit for bit, for every step, every
slice of rows and a ``text_len`` shorter than ``seq_len``.
"""
import numpy as np
import pytest
import torch

from repro.data import pipeline as JP
from repro_torch.data import pipeline as P


@pytest.mark.parametrize("kw", [
    dict(vocab_size=1000, seq_len=32, global_batch=16, seed=7),
    dict(vocab_size=50280, seq_len=64, global_batch=8, seed=0),
    dict(vocab_size=151655, seq_len=48, global_batch=4, seed=3,
         text_len=20, noise=0.3),
    dict(vocab_size=7, seq_len=5, global_batch=3, seed=1),
])
def test_host_batch_bit_equal(kw):
    cfg, jcfg = P.DataConfig(**kw), JP.DataConfig(**kw)
    for step in (0, 1, 5, 1000):
        for lo, hi in ((0, None), (1, 3), (cfg.global_batch - 1, None)):
            got = P.host_batch(cfg, step, lo, hi)
            want = JP.host_batch(jcfg, step, lo, hi)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype == np.int32
                np.testing.assert_array_equal(g, w)
    assert got[0].shape[1] == (kw.get("text_len") or kw["seq_len"])


def test_shard_slices_and_device_batch():
    cfg = P.DataConfig(vocab_size=1000, seq_len=32, global_batch=16, seed=7)
    full_t, full_g = P.host_batch(cfg, 4)
    part_t, part_g = P.host_batch(cfg, 4, 5, 9)
    np.testing.assert_array_equal(full_t[5:9], part_t)
    np.testing.assert_array_equal(full_g[5:9], part_g)
    assert not np.array_equal(full_t, P.host_batch(cfg, 5)[0])
    tokens, targets = P.device_batch(cfg, 4, "cpu")
    assert tokens.dtype == targets.dtype == torch.int32
    np.testing.assert_array_equal(tokens.numpy(), full_t)
    np.testing.assert_array_equal(targets.numpy(), full_g)
