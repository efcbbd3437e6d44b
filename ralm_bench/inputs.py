"""The benchmark's inputs, made on the device from ``--seed`` and handed
to the port and to the reference alike: the model's weights (made by the
configuration's reference module, ``reference/<reference>.py``, in the
port's parameter layout) and the IVF-PQ index.

Index (``Index``; residual or not, ``2 ** nbits`` codewords a
sub-space, as the configuration's ``index`` says): list lengths are a seeded
permutation of a fixed spread of lengths within +-``list_spread`` of the
mean, summing to ``num_vectors``; each list is striped over the shards
(element ``r`` of a list on shard ``r % S``), every shard's lists padded
to ``cap`` rows, the longest slice. Codes and the next-token payload are
seeded uniform. Coarse centroids and PQ codewords are the reference
model's own hidden states at seeded random prefixes, plus seeded noise,
so the model's queries fall near many different lists, as a real
datastore's do.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch



def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of ``seed`` (weights, index, traffic ...)."""
    words = [seed & 0xFFFFFFFF, seed >> 32] + [ord(c) for c in tag]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def reference_keys(family, params, model: dict, n: int, prefix_len: int,
                   seed: int, device, batch: int = 8) -> torch.Tensor:
    """``n`` hidden states [n, d] float32 of the reference model (the
    module ``family``), at the second half of the positions of seeded
    random token prefixes."""
    g = generator(seed, "keys", device)
    per = prefix_len - prefix_len // 2
    seqs = -(-n // per)
    toks = torch.randint(0, model["vocab_size"], (seqs, prefix_len),
                         generator=g, device=device)
    out = []
    for s in range(0, seqs, batch):
        h = family.hidden_states(params, model, toks[s:s + batch])
        out.append(h[:, prefix_len // 2:].reshape(-1, h.shape[-1]))
    return torch.cat(out)[:n]


def list_lengths(num_vectors: int, nlist: int, spread: float,
                 g: torch.Generator) -> torch.Tensor:
    """[nlist] int64 lengths: a permutation of ``nlist`` evenly spaced
    values in mean x [1 - spread, 1 + spread], floored, the remainder
    added one a list, so they sum to ``num_vectors``."""
    mean = num_vectors / nlist
    levels = torch.linspace(-1.0, 1.0, nlist, dtype=torch.float64)
    perm = torch.randperm(nlist, generator=g, device=g.device).cpu()
    lens = torch.floor(mean * (1.0 + spread * levels[perm])).long()
    short = num_vectors - int(lens.sum())
    lens[perm[:short]] += 1
    return lens


@dataclasses.dataclass
class Index:
    centroids: torch.Tensor      # [nlist, d] float32
    codebooks: torch.Tensor      # [m, 2 ** nbits, d / m] float32
    codes: torch.Tensor          # [S, nlist, cap, m] uint8
    ids: torch.Tensor            # [S, nlist, cap] int32, -1 past lens
    lens: torch.Tensor           # [S, nlist] int32
    base: torch.Tensor           # [nlist] int64: each list's first id
    payload: torch.Tensor        # [N] int32 next tokens
    residual: bool               # codes of x - its list's centroid

    @property
    def num_vectors(self) -> int:
        return int(self.lens.sum())

    def lists_of(self, ids: torch.Tensor) -> torch.Tensor:
        """The list [...] int64 of each of global ids [...] (all valid)."""
        return torch.searchsorted(self.base, ids.long(), right=True) - 1

    def codes_of(self, ids: torch.Tensor) -> torch.Tensor:
        """The codes [..., m] of global ids [...] (all valid)."""
        flat = ids.reshape(-1).long()
        lst = self.lists_of(flat)
        within = flat - self.base[lst]
        S = self.codes.shape[0]
        out = self.codes[within % S, lst, within // S]
        return out.reshape(ids.shape + (self.codes.shape[-1],))

    def resident_bytes(self) -> Dict[str, int]:
        return {name: t.numel() * t.element_size() for name, t in (
            ("codes", self.codes), ("ids", self.ids),
            ("payload", self.payload), ("centroids", self.centroids))}


def key_count(icfg: dict) -> int:
    """How many reference hidden states ``build_index`` takes."""
    return icfg["nlist"] + 2 ** icfg["nbits"]


def build_index(icfg: dict, keys: torch.Tensor, vocab: int, seed: int
                ) -> Index:
    """The synthetic index on ``keys``' device; ``keys`` [key_count, d]
    are reference hidden states: the centroids, then the codewords'
    sources (less their mean for a residual index, whose codewords
    stand for a vector's offset from its centroid)."""
    device = keys.device
    g = generator(seed, "index", device)
    nlist, m, S = icfg["nlist"], icfg["m"], icfg["num_shards"]
    ksub = 2 ** icfg["nbits"]
    d = keys.shape[1]
    noise = icfg["centroid_noise"] * keys.std(0, keepdim=True)
    cents = keys[:nlist] + noise * torch.randn(
        (nlist, d), generator=g, device=device)
    src = keys[nlist:nlist + ksub]
    if icfg["residual"]:
        src = src - src.mean(0, keepdim=True)
    src = src.view(ksub, m, d // m).transpose(0, 1)
    codebooks = (src + noise.view(m, 1, d // m) * torch.randn(
        (m, ksub, d // m), generator=g, device=device)).contiguous()
    lens = list_lengths(icfg["num_vectors"], nlist, icfg["list_spread"],
                        g).to(device)
    base = torch.cumsum(lens, 0) - lens
    per_shard = torch.stack([(lens - s + S - 1) // S for s in range(S)])
    cap = int(per_shard.max())
    codes = torch.randint(0, ksub, (S, nlist, cap, m), dtype=torch.uint8,
                          generator=g, device=device)
    rows = torch.arange(cap, dtype=torch.int32, device=device)
    ids = torch.stack([
        torch.where(rows[None] < per_shard[s, :, None].int(),
                    base[:, None].int() + rows[None] * S + s,
                    torch.full((), -1, dtype=torch.int32, device=device))
        for s in range(S)])
    payload = torch.randint(0, vocab, (int(lens.sum()),), dtype=torch.int32,
                            generator=g, device=device)
    return Index(centroids=cents.float().contiguous(), codebooks=codebooks,
                 codes=codes, ids=ids, lens=per_shard.int(), base=base,
                 payload=payload, residual=bool(icfg["residual"]))
