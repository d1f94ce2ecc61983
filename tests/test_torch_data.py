"""The port's data pipeline (``repro_torch.data``) against the JAX
package's (``repro.data``): both are numpy, so every draw is held
exactly — tokens, labels and enc-dec source frames over several steps and
host splits, the rebalanced split's tiling of the same global rows, and
the packed-file source."""
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.data import pipeline as jpipe
from repro_torch.configs import get_config
from repro_torch.data import (DataPipeline, MemmapSource, SyntheticSource,
                              write_corpus)
from repro_torch.data import pipeline as tpipe

ARCHS = ("qwen1.5-0.5b", "seamless-m4t-medium", "zamba2-2.7b")


def _equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("hosts", [1, 2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_batches_equal_the_reference(arch, hosts):
    jcfg = j_get_config(arch, reduced=True)
    tcfg = get_config(arch, reduced=True)
    for host in range(hosts):
        ref = jpipe.DataPipeline(jcfg, seq_len=32, global_batch=8,
                                 host_index=host, host_count=hosts)
        out = DataPipeline(tcfg, seq_len=32, global_batch=8,
                           host_index=host, host_count=hosts)
        for step in (0, 1, 7, 1000):
            _equal(out(step), ref(step))


def test_full_width_encdec_frames_equal_the_reference():
    """``seamless-m4t-medium`` at full width: source frames [2, 64, 1024]
    f32, as the trainer feeds its bf16 model."""
    ref = jpipe.DataPipeline(j_get_config("seamless-m4t-medium"),
                             seq_len=512, global_batch=2)(3)
    out = DataPipeline(get_config("seamless-m4t-medium"), seq_len=512,
                       global_batch=2)(3)
    assert out["src_embeds"].shape == (2, 64, 1024)
    assert out["src_embeds"].dtype == np.float32
    _equal(out, ref)


def test_counter_draws_equal_the_reference():
    idx = np.arange(1000, dtype=np.uint64)
    np.testing.assert_array_equal(tpipe._bits(7, idx), jpipe._bits(7, idx))
    np.testing.assert_array_equal(tpipe._uniform(7, idx),
                                  jpipe._uniform(7, idx))
    assert tpipe._key64(3, 5, 1) == jpipe._key64(3, 5, 1)
    src = SyntheticSource(256, seed=4)
    ref = jpipe.SyntheticSource(256, seed=4)
    np.testing.assert_array_equal(src.batch(2, 3, 40, row0=5),
                                  ref.batch(2, 3, 40, row0=5))


@pytest.mark.parametrize("count", [2, 4])
def test_rebalance_tiles_the_same_global_rows(count):
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    whole = DataPipeline(cfg, seq_len=16, global_batch=8)
    split = [whole.rebalance(h, count) for h in range(count)]
    jsplit = [jpipe.DataPipeline(j_get_config("qwen1.5-0.5b", reduced=True),
                                 seq_len=16, global_batch=8).rebalance(
                                     h, count) for h in range(count)]
    for step in (0, 5):
        for key in ("tokens", "labels"):
            tiled = np.concatenate([p(step)[key] for p in split])
            np.testing.assert_array_equal(tiled, whole(step)[key])
            np.testing.assert_array_equal(
                tiled, np.concatenate([p(step)[key] for p in jsplit]))
    with pytest.raises(ValueError):
        whole.rebalance(0, 3)  # 8 rows do not split over 3 hosts
    with pytest.raises(ValueError):
        whole.rebalance(2, 2)


def test_write_corpus_memmap_round_trip(tmp_path):
    toks = np.random.default_rng(0).integers(0, 1000, 5000)
    path = str(tmp_path / "corpus.bin")
    write_corpus(path, toks)
    np.testing.assert_array_equal(np.fromfile(path, np.uint32), toks)
    src = MemmapSource(path, vocab_size=1000, seed=3)
    ref = jpipe.MemmapSource(path, vocab_size=1000, seed=3)
    for step in (0, 9):
        out = src.batch(step, 4, 32, row0=2)
        np.testing.assert_array_equal(out, ref.batch(step, 4, 32, row0=2))
        starts = [int(np.flatnonzero(
            np.all(np.lib.stride_tricks.sliding_window_view(toks, 32)
                   == row, axis=1))[0]) for row in out]
        for s, row in zip(starts, out):  # each row is a window of the file
            np.testing.assert_array_equal(toks[s:s + 32], row)
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    pipe = DataPipeline(cfg, seq_len=31, global_batch=4, source=src)
    b = pipe(1)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
