"""Why a speculation rollback replays at the shape of the wave it stands
in for, on the GPU.

    python3 tools/spec_replay_shapes.py

Builds the chip smoke's Dec-S serve traffic (``chip_smoke.setup``: 8
requests x 4 rows, 448-token prompts, 64 greedy tokens, fused scan,
async retrieval) and drives it three times: without speculation; with
speculate_k=1 where each rollback's redo runs as a wave of the
rolled-back request alone (the engine's ``dispatch_wave`` called without
``shape``); and with speculate_k=1 as the engine ships it (the redo
padded to the bucket and kv_len of the wave it stands in for). For each
speculating run it prints whether its tokens equal the run without
speculation, how many (request, step) decode outputs differ in any bit
from that run's (logits or hidden state, as ``finish_wave`` receives
them) and the first; where the tokens first part, the logit and hidden
differences of that row, and the top three mixed log-probabilities of
the run without speculation there. Then, teacher-forced over request 0's
tokens, the same rows decoded as a wave of their own and padded to the
serve wave's bucket at the same kv_len, step by step; and 50 repeats of
``knnlm_interpolate`` on one wave's inputs (its ``scatter_add_`` adds
duplicate tokens' weights with atomics). It needs a CUDA GPU and exits
non-zero without one.
"""
from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def capture(eng, R):
    """Wrap ``eng.finish_wave`` to keep each (request, step)'s decode
    outputs and, for rows that waited on their search, its result."""
    log = {}
    finish = eng.finish_wave

    def wrapped(seqs, decoded, searches):
        for seq, (logits, hidden), search in zip(seqs, decoded, searches):
            res = (tuple(x.cpu() for x in search.result())
                   if hasattr(search, "result") else None)
            log[(seq.request.request_id % R, seq.step)] = (
                logits.float().cpu(), hidden.float().cpu(), res)
        return finish(seqs, decoded, searches)

    eng.finish_wave = wrapped
    return log


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        sys.exit("spec_replay_shapes: needs a CUDA GPU")
    import chip_smoke as cs

    print(cs.nvidia_smi(), flush=True)
    dev = torch.device("cuda")
    sizes = dict(cs.FULL)
    arch, cfg, params, corpus, _, ds = cs.setup(dev, sizes)
    trace(torch, dev, arch, cfg, params, corpus, ds, sizes)
    return 0


def trace(torch, dev, arch, cfg, params, corpus, ds, sizes):
    """The three runs, the teacher-forced comparison and the repeats."""
    import numpy as np
    import chip_smoke as cs
    from repro_torch.core import rag as rag_lib
    from repro_torch.serve import RalmEngine

    R, B, T0 = sizes["requests"], sizes["rows"], sizes["prompt_len"]
    steps = sizes["steps"]
    prompts = [corpus[r * B:(r + 1) * B, :T0] for r in range(R)]
    truth = corpus[:R * B, T0:T0 + steps]

    def run(eng, label):
        log = capture(eng, R)
        return cs.drive(torch, eng, cfg, prompts, truth, steps, label), log

    off_eng, _, _ = cs.checked_engine(torch, dev, arch, cfg, params, ds,
                                      sizes, fused=True)
    off, off_log = run(off_eng, "off")
    for mode in ("own_shape", "shipped"):
        eng, _, _ = cs.checked_engine(torch, dev, arch, cfg, params, ds,
                                      sizes, fused=True, speculate_k=1)
        if mode == "own_shape":
            eng.dispatch_wave = (lambda e: lambda seqs, shape=None:
                                 RalmEngine.dispatch_wave(e, seqs))(eng)
        got, log = run(eng, f"spec_k1_{mode}")
        differ = [key for key in sorted(log)
                  if not (torch.equal(log[key][0], off_log[key][0]) and
                          torch.equal(log[key][1], off_log[key][1]))]
        print(f"[{mode}] tokens_equal={np.array_equal(got['gen'], off['gen'])}"
              f" decode_outputs_differing={len(differ)}/{len(log)}"
              f" first_differing_request_step="
              f"{differ[0] if differ else None}", flush=True)
        if not np.array_equal(got["gen"], off["gen"]):
            fd = cs.first_difference(got["gen"], off["gen"], B)
            lg, hd, _ = log[(fd["request"], fd["step"])]
            lo, ho, (d, i) = off_log[(fd["request"], fd["step"])]
            row = fd["row"]
            toks = ds.payload_tokens.cpu()[i.clamp(min=0).long()]
            mixed = rag_lib.knnlm_interpolate(lo, d, toks, arch.rag.lam,
                                              arch.rag.temperature)
            top = torch.topk(mixed[row], 3)
            print(f"[{mode}] first_token_difference={fd} "
                  f"row_logits_max_abs_diff="
                  f"{(lg[row] - lo[row]).abs().max().item():.4e} "
                  f"row_hidden_max_abs_diff="
                  f"{(hd[row] - ho[row]).abs().max().item():.4e} "
                  f"off_run_top3_logprob={[round(v, 4) for v in top.values.tolist()]} "
                  f"tokens={top.indices.tolist()}", flush=True)
        if mode == "shipped":
            alone_vs_padded(torch, eng, prompts[0], off["gen"][:B], R * B)
        del eng
        torch.cuda.empty_cache()

    lo = torch.cat([off_log[(r, steps // 2)][0] for r in range(R)]).to(dev)
    d = torch.cat([off_log[(r, steps // 2)][2][0] for r in range(R)]).to(dev)
    i = torch.cat([off_log[(r, steps // 2)][2][1] for r in range(R)]).to(dev)
    toks = ds.payload_tokens[i.clamp(min=0).long()]
    outs = [rag_lib.knnlm_interpolate(lo, d, toks, arch.rag.lam,
                                      arch.rag.temperature)
            for _ in range(50)]
    dup = sum(len(set(t.tolist())) < t.numel() for t in toks.cpu())
    print(f"[knnlm_interpolate] step={steps // 2} rows={toks.shape[0]} "
          f"rows_with_duplicate_tokens={dup} repeats=50 "
          f"repeats_differing={sum(not torch.equal(o, outs[0]) for o in outs)}",
          flush=True)


def alone_vs_padded(torch, eng, prompt, gen, bucket):
    """Request 0's rows teacher-forced over ``gen`` twice, decoded each
    step as a wave of their own and padded to ``bucket`` rows at the
    same kv_len; prints how many steps' logits / hidden differ."""
    from repro_torch.serve import RalmRequest

    seqs = [eng.start(RalmRequest(prompt=torch.from_numpy(prompt),
                                  steps=gen.shape[1])) for _ in range(2)]
    first = torch.from_numpy(gen[:, 0]).to(eng.device, torch.int32)
    for seq in seqs:
        seq.logits0 = seq.hidden0 = None
        eng._emit(seq, first)
    diffs = []
    for s in range(1, gen.shape[1]):
        la, ha = eng.dispatch_wave([seqs[0]])[0]
        kv_len = seqs[0].wave_shapes[seqs[0].step][1]
        lb, hb = eng.dispatch_wave([seqs[1]], shape=(bucket, kv_len))[0]
        diffs.append(((la.float() - lb.float()).abs().max().item(),
                      (ha.float() - hb.float()).abs().max().item()))
        tok = torch.from_numpy(gen[:, s]).to(eng.device, torch.int32)
        for seq in seqs:
            eng._emit(seq, tok)
    for seq in seqs:
        eng.release(seq)
    bad = [s + 1 for s, (a, b) in enumerate(diffs) if a or b]
    print(f"[alone_vs_padded] bucket={bucket} steps={len(diffs)} "
          f"steps_differing={len(bad)} first={bad[:1]} "
          f"max_abs_diff_logits_hidden="
          f"{max(a for a, _ in diffs):.4e}/{max(b for _, b in diffs):.4e}",
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
