"""Counter-based random streams of the path tracer.

Every uniform a path draws is a pure function of (key, ray index, bounce,
slot): no state advances, so a ray's numbers do not depend on which other
rays are live, on how the wavefront is chunked, or on the device. The hash
is PCG's one-round output permutation (Jarzynski and Olano, "Hash
Functions for GPU Rendering", JCGT 2020) on 32-bit words held in int64
tensors, whose products stay below 2^63, so the CPU and CUDA give the same
bits.

- :func:`draw_key` takes one key in [0, 2^62) from a ``torch.Generator``,
  as a one-element int64 tensor on its device (no host read);
- :func:`bounce_table` hashes the key with every (bounce, slot) once per
  radiance call: [B, 1 + S] words;
- :func:`uniforms` gives a bounce's [R, S] uniforms in [0, 1) for ray
  indices [R]: ``pcg(pcg(index ^ T[b, 0]) ^ T[b, 1 + s])``, the top 24 bits
  of the word over 2^24 (exact in float32).
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
KEY_RANGE = 1 << 62
SLOT_STRIDE = 64  # (bounce, slot) -> bounce * SLOT_STRIDE + slot in the table hash


def pcg(v: torch.Tensor) -> torch.Tensor:
    """PCG's hash of 32-bit words [...] (int64 in [0, 2^32)), elementwise."""
    state = (v * 747796405 + 2891336453) & M32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & M32
    return (word >> 22) ^ word


def draw_key(generator: torch.Generator, device) -> torch.Tensor:
    """One key [1] int64 in [0, 2^62) from ``generator`` (on ``device``)."""
    return torch.randint(0, KEY_RANGE, (1,), generator=generator, device=device,
                         dtype=torch.int64)


def bounce_table(key: torch.Tensor, n_bounces: int, n_slots: int) -> torch.Tensor:
    """[n_bounces, 1 + n_slots] words: column 0 mixes the ray index of a
    bounce, column 1 + s the slot s."""
    if n_slots + 1 > SLOT_STRIDE:
        raise ValueError(f"at most {SLOT_STRIDE - 1} slots, got {n_slots}")
    b = torch.arange(n_bounces, dtype=torch.int64, device=key.device)[:, None]
    s = torch.arange(n_slots + 1, dtype=torch.int64, device=key.device)[None, :]
    k0, k1 = key & M32, (key >> 32) & M32
    return pcg(pcg(pcg(b * SLOT_STRIDE + s) ^ k0) ^ k1)


def uniforms(table: torch.Tensor, bounce: int, index: torch.Tensor) -> torch.Tensor:
    """Uniforms [R, S] in [0, 1 - 2^-24] of bounce ``bounce`` for ray
    indices ``index`` [R] (int64, below 2^32), float32."""
    row = table[bounce]
    h = pcg(index ^ row[0])
    w = pcg(h[:, None] ^ row[None, 1:])
    return (w >> 8).to(torch.float32) * (1.0 / (1 << 24))
