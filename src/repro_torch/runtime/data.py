"""Deterministic synthetic data pipeline (the reference's
``repro/runtime/data.py``).

Tokens are a pure function of (seed, step, position), drawn with the
threefry2x32 generator exactly as ``jax.random`` draws them, so the port's
batches equal the reference's bit for bit: ``PRNGKey(seed)``, ``fold_in``
of the step, ``randint`` over ``(global_batch, seq + 1)``.  The generator
is written in numpy uint32 arithmetic after ``jax/_src/prng.py``
(``threefry2x32``, ``threefry_seed``, ``threefry_fold_in``,
``_threefry_split_foldlike``, ``_threefry_random_bits_partitionable``)
and ``jax/_src/random.py`` (``_randint``: two draws of 32 bits combined
modulo the span), as jax 0.9.0 defines them with
``jax_threefry_partitionable=True``, its default.  A checkpoint of the
pipeline is one integer, ``step``.

``batch_at(step, extras={name: shape})`` also draws float32 normals for
stub inputs.  The reference keys each with ``fold_in(key, hash(name) %
2**31)``; Python salts ``str`` hashes per process, so its extras differ
between runs (ROADMAP C21).  The port keys them with a stable hash of the
name (CRC-32) and draws ``sqrt(2) * erfinv(u)`` from threefry uniforms, the
reference's formula; its normals are reproducible across processes but
are not the reference's numbers.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from .. import resolve_device

U32 = np.uint32
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << U32(r)) | (v >> U32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray) -> tuple:
    """The Threefry-2x32 block cipher (20 rounds) of the counter pairs
    ``(x0, x1)`` under ``key = (k0, k1)``: two uint32 arrays."""
    k0, k1 = U32(key[0]), U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ U32(0x1BD11BDA))
    x = [np.asarray(x0, U32) + ks[0], np.asarray(x1, U32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + U32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**31): (0, seed)."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} outside [0, 2**31)")
    return (U32(0), U32(seed))


def fold_in(key, data: int) -> tuple:
    """``jax.random.fold_in``: the cipher of the counter (0, data)."""
    y0, y1 = threefry2x32(key, np.array([0], U32),
                          np.array([int(data) & 0xFFFFFFFF], U32))
    return (y0[0], y1[0])


def split(key, num: int = 2) -> list:
    """``jax.random.split`` (the fold-like split): key i is the cipher of
    the counter (0, i)."""
    y0, y1 = threefry2x32(key, np.zeros(num, U32), np.arange(num, dtype=U32))
    return [(y0[i], y1[i]) for i in range(num)]


def random_bits(key, shape) -> np.ndarray:
    """32 random bits per element: the two words of the cipher of the
    element's flat index (hi 0, lo index), xored."""
    n = int(np.prod(shape))
    if n >= 2 ** 32:
        raise ValueError("random_bits: more than 2**32 elements")
    y0, y1 = threefry2x32(key, np.zeros(n, U32), np.arange(n, dtype=U32))
    return (y0 ^ y1).reshape(shape)


def randint(key, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``:
    two draws of 32 bits, ``(hi % span) * (2**32 % span) + lo % span``
    modulo the span, in uint32 arithmetic."""
    if not -2 ** 31 <= minval < maxval <= 2 ** 31 - 1:
        raise ValueError(f"randint: [{minval}, {maxval}) outside int32")
    k1, k2 = split(key)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = U32(maxval - minval)
    with np.errstate(over="ignore"):
        mult = U32(2 ** 16) % span
        mult = (mult * mult) % span
        off = ((hi % span) * mult + lo % span) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)


def normal(key, shape) -> torch.Tensor:
    """float32 normals ``sqrt(2) * erfinv(u)``, u uniform in (-1, 1) from
    threefry bits as ``jax.random.uniform`` makes them (``erfinv`` is
    PyTorch's, not XLA's: the numbers are close to the reference's, not
    equal)."""
    bits = random_bits(key, shape)
    f = ((bits >> U32(9)) | U32(0x3F800000)).view(np.float32) - np.float32(1)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = np.maximum(lo, f * (np.float32(1) - lo) + lo)
    return torch.erfinv(torch.from_numpy(u)) * np.float32(np.sqrt(2))


def stable_hash(name: str) -> int:
    """The key of an extra's name: CRC-32 modulo 2**31, the same in every
    process (the reference's ``hash(name)`` is salted per process, C21)."""
    return zlib.crc32(name.encode()) % 2 ** 31


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq: int
    global_batch: int
    seed: int = 0


class SyntheticDataset:
    """Stateless-per-step synthetic LM batches: int32 ``tokens`` and
    ``labels`` (the next tokens), each (global_batch, seq), on
    ``device``."""

    def __init__(self, cfg: DataConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.step = 0

    def batch_at(self, step: int, extras: dict | None = None) -> dict:
        c = self.cfg
        key = fold_in(prng_key(c.seed), step)
        toks = torch.from_numpy(randint(key, (c.global_batch, c.seq + 1), 0,
                                        c.vocab)).to(self.device)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if extras:
            for name, shape in extras.items():
                k = fold_in(key, stable_hash(name))
                batch[name] = normal(k, tuple(shape)).to(self.device)
        return batch

    def __next__(self):
        b = self.batch_at(self.step)
        self.step += 1
        return b

    # -- checkpointing --------------------------------------------------- #
    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def load_state_dict(self, d: dict) -> None:
        if d["seed"] != self.cfg.seed:
            raise ValueError(f"seed mismatch on restore: checkpoint "
                             f"{d['seed']}, dataset {self.cfg.seed}")
        self.step = int(d["step"])
