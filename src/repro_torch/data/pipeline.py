"""Deterministic sharded data pipeline — a copy of ``repro.data.pipeline``
(plain numpy: the draws, and so every token, label and enc-dec source
frame, are the reference's exactly). Batches stay numpy; the trainer moves
them to its device.

Two sources behind one interface:
  * ``SyntheticSource`` — structured pseudo-text (Zipfian unigrams + repeated
    motifs so models actually learn); fully determined by (seed, step), which
    makes checkpoint-resume exact with no iterator state to save.
  * ``MemmapSource``    — packed uint32 token binaries (produced by
    ``write_corpus``), random windows indexed by (seed, step).

Per-host sharding: every global-batch row is fully determined by
(seed, step, global_row); a host materializes only its rows
[host_index * per_host : (host_index+1) * per_host]. Because rows never
depend on the host split, any (host_index, host_count) partition covers the
same global rows exactly once at per-host cost — the property the elastic
restart's ``rebalance`` relies on: after a mesh shrink, the survivors'
slices tile the identical batches the old fleet would have produced.

Randomness is counter-based (vectorized splitmix64 over (key, global
counter) — the Philox idea without per-row Generator construction): one
numpy expression per host slice, no O(batch) Python loop seeding PCG64
states on the hot data path.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ModelConfig

# --- counter-based uniform bits ----------------------------------------------

_GOLD = 0x9E3779B97F4A7C15


def _bits(key: int, idx) -> np.ndarray:
    """splitmix64 finalizer over (key + counter): iid 64-bit words,
    vectorized over any counter array. Deterministic across hosts.

    Works on >=1-d arrays internally: numpy wraps array integer overflow
    silently but emits RuntimeWarning for scalars.
    """
    a = np.asarray(idx, np.uint64)
    z = (np.atleast_1d(a) + np.uint64(key)) * np.uint64(_GOLD)
    z ^= z >> np.uint64(30)
    z = z * np.uint64(0xBF58476D1CE4E5B9)
    z ^= z >> np.uint64(27)
    z = z * np.uint64(0x94D049BB133111EB)
    z ^= z >> np.uint64(31)
    return z.reshape(a.shape)


def _uniform(key: int, idx) -> np.ndarray:
    """float64 in [0, 1) from the top 53 bits."""
    return (_bits(key, idx) >> np.uint64(11)).astype(np.float64) * 2.0 ** -53


def _key64(*parts) -> int:
    """Fold integer parts into one 64-bit stream key."""
    k = 0x243F6A8885A308D3
    for p in parts:
        k = int(_bits(k, np.uint64(int(p) & (2 ** 64 - 1))))
    return k


@dataclasses.dataclass
class SyntheticSource:
    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.3
    motif_len: int = 16

    def batch(self, step: int, batch: int, seq: int,
              row0: int = 0) -> np.ndarray:
        """Rows ``row0 .. row0+batch-1`` of step ``step``'s global batch.

        All randomness is counter-indexed by the *global* row, so a host
        materializes only its slice (one vectorized draw) yet any host
        split tiles the same global rows.
        """
        v = self.vocab_size
        mlen = min(self.motif_len, seq)  # short sequences truncate motifs
        n_inj = max(1, seq // (4 * self.motif_len))
        key = _key64(self.seed, step)
        # motif table is global per step: repeatable n-grams the model can
        # learn, shared across hosts
        motifs = (1 + _bits(_key64(self.seed, step, 1),
                            np.arange(8 * mlen))
                  % max(1, v - 1)).astype(np.int32).reshape(8, mlen)
        # fixed per-row counter budget: seq token draws + n_inj (choice, pos)
        stride = seq + 2 * n_inj
        gidx = ((row0 + np.arange(batch, dtype=np.uint64))[:, None]
                * np.uint64(stride) + np.arange(stride, dtype=np.uint64))
        # zipf-tail tokens by inverse transform (u^(-1/(a-1)) is the Pareto
        # tail underlying the Zipf sampler; rejection-free -> vectorizable)
        u = np.clip(_uniform(key, gidx[:, :seq]), 1e-12, None)
        raw = np.floor(u ** (-1.0 / (self.zipf_a - 1.0)))
        base = ((np.minimum(raw, 2 ** 31 - 1).astype(np.int64) - 1)
                % max(2, v - 2) + 1).astype(np.int32)
        choice = _bits(key, gidx[:, seq : seq + n_inj]) % np.uint64(8)
        pos = _bits(key, gidx[:, seq + n_inj :]) \
            % np.uint64(max(1, seq - mlen))
        for t in range(n_inj):  # small constant loop, vectorized over rows
            idx = pos[:, t].astype(np.int64)[:, None] \
                + np.arange(mlen)[None, :]
            np.put_along_axis(base, idx, motifs[choice[:, t].astype(int)],
                              axis=1)
        return base


@dataclasses.dataclass
class MemmapSource:
    path: str
    vocab_size: int
    seed: int = 0

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=np.uint32, mode="r")

    def batch(self, step: int, batch: int, seq: int,
              row0: int = 0) -> np.ndarray:
        n = len(self._data) - seq - 1
        starts = _bits(_key64(self.seed, step, 2),
                       row0 + np.arange(batch, dtype=np.uint64)) % np.uint64(n)
        return np.stack([self._data[int(s) : int(s) + seq]
                         for s in starts]).astype(np.int32)


def write_corpus(path: str, tokens: np.ndarray):
    np.asarray(tokens, dtype=np.uint32).tofile(path)


@dataclasses.dataclass
class DataPipeline:
    cfg: ModelConfig
    seq_len: int
    global_batch: int
    source: object = None
    host_index: int = 0
    host_count: int = 1

    def __post_init__(self):
        if self.source is None:
            self.source = SyntheticSource(self.cfg.vocab_size)
        if not (0 <= self.host_index < self.host_count):
            raise ValueError(
                f"host_index {self.host_index} outside host_count "
                f"{self.host_count}")
        if self.global_batch % self.host_count != 0:
            raise ValueError(
                f"global_batch {self.global_batch} not divisible by "
                f"host_count {self.host_count}")
        self.per_host = self.global_batch // self.host_count

    def rebalance(self, host_index: int, host_count: int) -> "DataPipeline":
        """New pipeline with a different host split, same source/seed.

        The elastic-restart hook: after ``plan_elastic_mesh`` shrinks the
        fleet, each survivor re-enters with its compacted index (see
        ``fault_tolerance.survivor_split``) and the (seed, step) indexing
        keeps batches deterministic across the mesh change.
        """
        return dataclasses.replace(
            self, host_index=host_index, host_count=host_count)

    def __call__(self, step: int) -> dict:
        lo = self.host_index * self.per_host
        toks = self.source.batch(step, self.per_host, self.seq_len + 1,
                                 row0=lo)
        batch = {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].astype(np.int32),
        }
        if self.cfg.family in ("encdec", "audio"):
            src = self.seq_len // self.cfg.src_ratio
            per = src * self.cfg.d_model
            gidx = ((lo + np.arange(self.per_host, dtype=np.uint64))[:, None]
                    * np.uint64(2 * per)
                    + np.arange(2 * per, dtype=np.uint64))
            u = _uniform(_key64(17, step), gidx)
            u1 = np.clip(u[:, :per], 1e-12, None)
            z = np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u[:, per:])
            batch["src_embeds"] = z.reshape(
                self.per_host, src, self.cfg.d_model).astype(np.float32)
        return batch
