"""Whether what the timed path served is correct.

Once the window has closed, a sample of the finished requests, drawn from
the seed and holding the longest of them, goes through the configuration's
plain reference, which makes the weights again from the seed: the prompt
followed by the served tokens, in one full-sequence forward. Each served
token was greedy, so at each position the reading is the gap by which the
served token's reference logit lies below the reference's best. compare()
gives the widest gap (`max_logit_gap`), the mean gap (`mean_logit_gap`)
and the share of positions whose served token is not the reference's best
(`off_top1_share`); the numbers a cell compares are those its cell file
gives a limit (`limits`).

The control (run.py --control 1) is the same reference one precision
below the configuration (reference.control): every matrix product's input
rounded to fp8 where the configuration serves bf16 activations, and a
bf16 KV cache stored in fp8: at each position of the same sequences, the
gap of the token that it puts first. Its numbers (`control_<name>`) take
the program's place in the run's checks.
"""

from __future__ import annotations

import numpy as np
import torch

from . import weights


def sample(records, seed: int, served: int, requests: int) -> list:
    """The finished requests to check: the one that served the most tokens
    (the lowest uid among equals), then others in an order drawn from the
    seed until the sample holds `served` tokens and `requests` requests
    (or every finished request)."""
    done = sorted((r for r in records.values() if r.tokens is not None),
                  key=lambda r: r.uid)
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.tokens), -r.uid))
    rng = np.random.default_rng(weights.sub_seed(seed, weights.SAMPLE))
    picked, total = [longest], len(longest.tokens)
    for j in rng.permutation(len(done)):
        if total >= served and len(picked) >= requests:
            break
        if done[j] is not longest:
            picked.append(done[j])
            total += len(done[j].tokens)
    return picked


def compare(ref_mod, conf: dict, seed: int, device, picked: list,
            control: bool) -> dict:
    """The numbers compared for the sampled requests."""
    seqs = [np.concatenate([r.prompt, np.asarray(r.tokens[:-1], np.int64)])
            for r in picked]
    starts = [len(r.prompt) - 1 for r in picked]
    variants = (ref_mod.Variant(),)
    if control:
        variants += (ref_mod.control(conf),)
    ref = ref_mod.Reference(conf, seed, device, variants=variants)
    logits = ref.logits(seqs, starts)
    gaps, ctl = [], []
    for i, r in enumerate(picked):
        lg = logits[0][i]
        best = lg.max(dim=-1).values
        served = torch.as_tensor(r.tokens, dtype=torch.long,
                                 device=lg.device)
        rows = torch.arange(len(r.tokens), device=lg.device)
        gaps.append(best - lg[rows, served])
        if control:
            pick = logits[1][i].argmax(dim=-1)
            ctl.append(best - lg[rows, pick])
    out = {"requests": len(picked),
           "tokens": sum(len(r.tokens) for r in picked)}
    out.update(_summary(torch.cat(gaps)))
    if control:
        out.update({f"control_{k}": v
                    for k, v in _summary(torch.cat(ctl)).items()})
    return out


def _summary(g: torch.Tensor) -> dict:
    """The widest gap, the mean gap, and the share of positions whose
    token is not the reference's best."""
    return {"max_logit_gap": float(g.max()), "mean_logit_gap":
            float(g.mean()), "off_top1_share": float((g > 0).float().mean())}
