"""Quality evaluation: log-likelihood scoring, multiple-choice accuracy
(MMLU-style), perplexity, and a BF16-vs-FP4 accuracy-delta harness (torch).

Counterpart of petit_kernel_tpu/models/eval.py, under the same names and
arguments less `interpret` (the port has no interpret mode). Scoring runs
on the device of `params`, or of the engine:

  - without an engine, one full-sequence llama.forward with no cache (the
    port's causal f32 attention, as the JAX package's is its XLA path);
  - with engine= (a serving.Engine or PagedEngine), through
    engine.score_forward: the engine's own prefill forward over a scratch
    cache of its layout and dtype, so the score measures the configuration
    that is served (on the card, its flash prefill kernel).

Rows are grouped by padded length (a multiple of `bucket`) and scored in
batches of `batch` rows (engine.B with an engine), the last batch padded
with empty rows; continuation log-probs are summed in f32 under a position
mask, so no shape is ragged.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from . import llama


def _pad_to(x: np.ndarray, L: int) -> np.ndarray:
    out = np.zeros(L, np.int32)
    out[: len(x)] = x
    return out


def _pad_to_f(x: np.ndarray, L: int) -> np.ndarray:
    out = np.zeros(L, np.float32)
    out[: len(x)] = x
    return out


@torch.inference_mode()
def _score_batch(params, toks, cont_mask, cfg, fmt):
    """Sum of log P(tok[t] | tok[:t]) over positions where cont_mask[t] = 1.

    toks (B, L) int32, cont_mask (B, L) f32. Position t's probability comes
    from the logits at t - 1, so the first position of a row is never
    scored (a continuation always has a non-empty context in front of
    it)."""
    logits, _ = llama.forward(params, toks[:, :-1], cfg, fmt=fmt)
    return _sum_cont_logprobs(logits, toks, cont_mask)


def _sum_cont_logprobs(logits, toks, cont_mask):
    logp = torch.log_softmax(logits.float(), dim=-1)
    tgt = toks[:, 1:].long()
    tok_lp = torch.gather(logp, -1, tgt[..., None])[..., 0]
    return (tok_lp * cont_mask[:, 1:]).sum(-1)


def loglikelihood(params, cfg: llama.LlamaConfig,
                  pairs: Sequence[tuple[Sequence[int], Sequence[int]]], *,
                  fmt: str = "bf16", bucket: int = 32, batch: int = 8,
                  engine=None) -> np.ndarray:
    """log P(continuation | context) for each (context, continuation) pair
    of token-id sequences. Returns (len(pairs),) float64.

    engine: a serving.Engine or PagedEngine; scoring then runs through the
    engine's score_forward, at batch engine.B, and params, cfg and fmt
    give way to the engine's own."""
    rows, masks, lens = [], [], []
    for ctx, cont in pairs:
        assert len(ctx) >= 1, "continuation needs a non-empty context"
        ids = np.asarray(list(ctx) + list(cont), np.int32)
        m = np.zeros(len(ids), np.float32)
        m[len(ctx):] = 1.0
        rows.append(ids)
        masks.append(m)
        lens.append(len(ids))
    if engine is not None:
        cfg = engine.cfg
        batch = engine.B          # score_forward takes max_batch rows
        device = engine.device
    else:
        device = params["embed"].device
    out = np.zeros(len(pairs), np.float64)
    # group by padded length, then score in fixed-size batches
    order = np.argsort(lens, kind="stable")
    for start in range(0, len(order), batch):
        idx = order[start: start + batch]
        L = -(-max(lens[i] for i in idx) // bucket) * bucket
        L = min(L, cfg.max_seq_len)
        assert max(lens[i] for i in idx) <= cfg.max_seq_len, "row too long"
        toks = np.stack([_pad_to(rows[i], L) for i in idx])
        cm = np.stack([_pad_to_f(masks[i], L) for i in idx])
        # pad the batch too, so every batch of one L has one shape
        pad_b = batch - len(idx)
        if pad_b:
            toks = np.concatenate([toks, np.zeros((pad_b, L), np.int32)])
            cm = np.concatenate([cm, np.zeros((pad_b, L), np.float32)])
        toks_t = torch.from_numpy(toks).to(device)
        cm_t = torch.from_numpy(cm).to(device)
        if engine is not None:
            logits = engine.score_forward(toks_t[:, :-1])
            scores = _sum_cont_logprobs(logits, toks_t, cm_t)
        else:
            scores = _score_batch(params, toks_t, cm_t, cfg, fmt)
        out[idx] = scores.double().cpu().numpy()[: len(idx)]
    return out


def perplexity(params, cfg: llama.LlamaConfig, tokens: Sequence[int], *,
               fmt: str = "bf16") -> float:
    """exp(mean NLL) of tokens[1:] given tokens[:1] rolling context."""
    ids = list(tokens)
    (ll,) = loglikelihood(params, cfg, [(ids[:1], ids[1:])], fmt=fmt,
                          batch=1)
    return float(np.exp(-ll / (len(ids) - 1)))


# -- multiple choice ---------------------------------------------------------


def score_multiple_choice(params, cfg: llama.LlamaConfig,
                          questions: Sequence[dict], *, fmt: str = "bf16",
                          batch: int = 8, engine=None):
    """Each question: {"context": [ids], "choices": [[ids], ...],
    "answer": int}. Picks argmax_choice log P(choice | context) (the
    lm-eval-harness MMLU protocol). Returns (accuracy, picks).
    engine: score through a serving engine (see loglikelihood)."""
    pairs, spans = [], []
    for q in questions:
        spans.append((len(pairs), len(q["choices"])))
        pairs.extend((q["context"], ch) for ch in q["choices"])
    lls = loglikelihood(params, cfg, pairs, fmt=fmt, batch=batch,
                        engine=engine)
    picks = [int(np.argmax(lls[s: s + n])) for s, n in spans]
    correct = sum(p == q["answer"] for p, q in zip(picks, questions))
    return correct / len(questions), picks


MMLU_PREAMBLE = ("The following are multiple choice questions (with "
                 "answers) about {subject}.\n\n")
_LETTERS = "ABCD"


def format_mmlu(question: str, choices: Sequence[str], *,
                subject: str = "miscellaneous",
                few_shot: Sequence[tuple[str, Sequence[str], int]] = ()):
    """(context_text, choice_texts) in the standard MMLU prompt format;
    the choice text scored is ' A'/' B'/... after 'Answer:'."""
    ctx = MMLU_PREAMBLE.format(subject=subject.replace("_", " "))
    for fq, fch, fans in few_shot:
        ctx += _one_question(fq, fch) + f" {_LETTERS[fans]}\n\n"
    ctx += _one_question(question, choices)
    return ctx, [f" {_LETTERS[i]}" for i in range(len(choices))]


def _one_question(q: str, choices: Sequence[str]) -> str:
    lines = [q.strip()]
    lines += [f"{_LETTERS[i]}. {c}" for i, c in enumerate(choices)]
    lines.append("Answer:")
    return "\n".join(lines)


def mmlu_questions(rows: Sequence[tuple[str, Sequence[str], int]],
                   encode: Callable[[str], list[int]], *,
                   subject: str = "miscellaneous",
                   few_shot: Sequence[tuple[str, Sequence[str], int]] = ()):
    """Tokenize MMLU rows (question, choices, answer_idx) into
    score_multiple_choice inputs. `encode` is any text->ids callable (e.g.
    a tokenizer's encode); continuations are tokenized as the suffix of
    context+choice, so merges across the boundary are exact."""
    out = []
    for q, choices, ans in rows:
        ctx_text, choice_texts = format_mmlu(q, choices, subject=subject,
                                             few_shot=few_shot)
        ctx_ids = encode(ctx_text)
        conts = []
        for ct in choice_texts:
            full = encode(ctx_text + ct)
            assert full[: len(ctx_ids)] == ctx_ids, \
                "tokenizer merged across the context boundary"
            conts.append(full[len(ctx_ids):])
        out.append({"context": ctx_ids, "choices": conts, "answer": ans})
    return out


def fp4_accuracy_delta(params, cfg: llama.LlamaConfig,
                       questions: Sequence[dict], *, fmt: str = "nvfp4",
                       **quant_kw):
    """The north-star quality check at any scale: accuracy of the dense
    BF16 model against its FP4-quantized self (llama.quantize_params) on
    the same questions."""
    acc_bf16, _ = score_multiple_choice(params, cfg, questions, fmt="bf16")
    qparams = llama.quantize_params(params, fmt, **quant_kw)
    acc_fp4, _ = score_multiple_choice(qparams, cfg, questions, fmt=fmt)
    return {"bf16": acc_bf16, fmt: acc_fp4, "delta": acc_bf16 - acc_fp4}
