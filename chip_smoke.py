"""Smoke run of petit_kernel_tpu_torch on one NVIDIA Hopper card.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --record out/chip_smoke.json   # keep a record

Phases (any failure raises and the script exits non-zero):
  1 device   require CUDA; print the card, CUDA, nvcc and nvidia-smi lines
  2 build    compile csrc/*.cu through ops/_build.py, print the seconds;
             log and record each kernel's ptxas registers, spills and
             C7515 warnings (the six instances of the split-KV decode body
             csrc/decode_attention.cuh among them; the four instances of
             the high-precision 64-row body csrc/fp4_hp_wgmma.cuh must
             show no spill and no C7515)
  3 kernels  each kernel against its plain PyTorch twin on the card, at the
             Llama-3-8B serving shapes (headed kernels at page sizes 16
             and 256, bf16 and fp8 K/V; the W4A8 GEMM and both weight-cache
             GEMMs at prefill, m = 512 and 2048, bit for bit against their
             twin and their non-cache counterparts, with a sweep of m
             against fp4_gemm, whose 64-row tiles there are the row
             fp4_gemm_prefill; the 64-row tiles of fp4_gemm, its weight
             cache, the grouped GEMM (cap 128) and the hybrid GEMM's FP4
             columns (m = 512) all run the wgmma body of
             csrc/fp4_wgmma.cuh, the hybrid GEMM's dense columns the bf16
             wgmma body of csrc/dense_wgmma.cuh (TMA copies), the W4A8
             GEMM's 64-row tiles and its weight cache's (G m-tiles a CTA
             sharing one requantization, also at m = 200 and 300, a
             partial last m-group) the int8
             wgmma body of csrc/w4a8_wgmma.cuh, the 16-row tiles mma.sync
             bodies (the split-k stream csrc/fp4_stream.cuh for fp4_gemm,
             its weight cache (4 m-tiles a CTA), the grouped GEMM and the
             hybrid GEMM, the split-k int8 stream csrc/w4a8_stream.cuh for
             both W4A8 kernels; the three 16-row weight caches and the
             plain W4A8 tile also timed alone, warm and as a CUDA graph of
             the four projections, the plain W4A8 tile at m = 16 and the
             weight caches at m = 64, at their default splits and counted
             as stream launches, the FP4 weight cache at 16x64 and 16x128,
             bit for bit fused_mul's plain 16-row tile at the same splits,
             with a sweep of 1 to 8 splits at 16x64);
             fp4_gemm at the four
             Llama-3-8B projections, m = 1, 8 and 256, its default tile
             and k-splits, two launches
             bit for bit, L2-warm and L2-flushed beside torch.matmul, the
             m = 8 layer also as a CUDA graph of the four (cold weights),
             and a sweep of 1 to 8 splits there; the dequant kernel at the
             four fused
             projections, nvfp4 and mxfp4, bit for bit; the hybrid GEMM at
             the seven unfused projections, m = 8 and 512, at the default
             k-splits and, at m = 8, at 1, 2, 3 and one per step, each
             launched twice for the same bits, its FP4 columns bit for bit
             against fused_mul at the same tile with one split, timed
             L2-warm and L2-flushed; at m = 512 also its dense columns
             alone, a launch with no FP4 columns, bit for bit the full
             launch's, beside torch.matmul(a, wd[:k]) and their bound, and
             its FP4 columns alone through fused_mul) and, for the
             grouped expert GEMM, Mixtral-8x7B's expert shapes (E=8, cap 8
             and 128, mxfp4 and nvfp4, also bit for bit against fused_mul
             per expert at the same split count), and one Mixtral layer's
             three grouped calls at cap 8 with every bucket row filled and
             with the buckets that top-2 routing of 4 seeded tokens fills
             (rows past each bucket's count skipped through `rows`, bit for
             bit the launch without it), warm and as a CUDA graph of the
             three; the KV append body (csrc/kv_append.cu): the flat, headed
             (bf16, fp8) and paged (bf16, fp8, page size 16) writes bit for
             bit their twins at one token (B = 8) and at a 256-token chunk
             (B = 2, one row masked, K and V strided views of a fused qkv
             tensor), its fp8 rounding of all 65,536 bf16 patterns against
             torch's cast, each entry's CUDA graph replayed with new
             positions against eager launches, the paged write beside the
             torch glue it replaced (as a graph); the three prefill attention
             kernels (flat bf16,
             headed fp8, paged fp8 at page size 16) also at the serving
             shape, one 512-token chunk at pos0 = 0 (window 512) and at
             pos0 = 1536 (window 2048), beside one SDPA call over bf16
             K/V, each prefill and KV append row also timed as a CUDA
             graph of 20 or 24 launches (graph_ms: device time, no host
             time between launches; the decode attention rows, the
             split-KV body csrc/decode_attention.cuh, too, each also
             launched twice for the same bits, the flat row beside SDPA
             over the strided view and over a contiguous copy, labelled);
             with CUDA-event times of the kernel, its twin and
             one PyTorch library call for the same work where there is
             one, and each call's bound (bytes over 3.35 TB/s or operations
             over the peak of their type, 989 TFLOP/s bf16 or 1,979 TOP/s
             int8, whichever is larger); the grouped cap-128 and hybrid
             m = 512 layer sums with their bound and library time; the
             speculative tick's verify shapes: the KV append of a (4, T)
             chunk with one row masked (bit for bit its twin), then flash
             prefill over it against its twin, flat bf16 and headed fp8,
             T = 4, 6, 8 and 12, mixed pos0, and fp4_gemm at m = 16, 24,
             32 and 48 over the four Llama-3-8B projections, two launches
             bit for bit, against its twin
  4 solutions the GEMM API's solution layer: (a) the high-precision
             kernels, fp4_gemm_hp at the four Llama-3-8B projections, m =
             8, nvfp4 with f32 and with bf16 activations at 16x64, f32 at
             16x128, and mxfp4 on wqkv, and at m = 2048 (the default tile,
             64x128: the register-A wgmma body csrc/fp4_hp_wgmma.cuh),
             fp4_gemm_hp_wc at m = 64 (16x64, its 16-row tiles) and 2048
             (the default tile), each weight cache bit for bit
             fp4_gemm_hp at the same tile and splits, every 16-row launch
             counted as a launch of the stream kernel, every 64-row one as
             a launch of the wgmma body,
             two launches the same bits, the 16-row rows also L2-flushed
             and as a CUDA graph of the four projections beside f32
             torch.matmul, each
             held against an f64 product of the same dequantized weights:
             max|hp - f64| <= 4 max|f32 library - f64| + 2^-24 max(|A| @
             |B|) |gs|, the f32 library being the plain version's
             torch.matmul with TF32 off; (b) every id get_fp4_solutions
             lists, hp included, nvfp4 and mxfp4, at (8, 4096, 4096), (100,
             6144, 4096) and (2048, 4096, 14336) through the public entries,
             each against its plain version; (c) the autotuner
             (tune_suite over the four projections at m = 16 and 2048,
             not saved) and every id of the committed H100 table launched
             once at its key; (d) the port's GEMM bench and its JSON line;
             (e) once each, on short runs: tune_grouped_shape, the bench's
             other formats, --trace, --shard70b and --tune, and the bench
             CLI
  5 parity   a 2-layer Llama-3-8B-width model and a 1-layer
             Mixtral-8x7B-width model: one prefill chunk and one decode
             step on the card (kernels) against the same model on the CPU
             (plain twins), Llama over the flat bf16 cache and over an fp8
             page pool (forward_paged, page size 16), the Llama quantized
             "hybrid" over the flat bf16 cache, Mixtral over the flat bf16
             cache; logits within 2^-5 * max|logits|; one 256-token W4A8
             prefill chunk of the Llama (fmt="w4a8"), within the larger of
             that and W4A8's own distance from nvfp4 on the CPU; and the
             loss and gradients of a 1-layer nvfp4 Llama (64 tokens) on the
             card (dequant kernel) against the CPU, each gradient within
             2^-5 * max|CPU gradient|; score_forward of the 2-layer Llama's
             Engine (flat bf16) and fp8 PagedEngine (page size 16) and of
             the 1-layer Mixtral's Engine on the card (flash prefill
             kernels over a scratch cache) against the CPU prefill chunk,
             the same computation, within 2^-5 * max|logits|; and the
             Llama's score_forward at L = 2047 with max_batch 4 (flash
             prefill at T = L over a 2048 window, the FP4 GEMM at m =
             8188) in the flat bf16 Engine, the headed fp8 Engine and the
             fp8 PagedEngine against the CPU's chunk of the same KV dtype,
             within the same bound
  6 serve    the full 32-layer Llama-3-8B, random nvfp4 weights quantized
             on the card, Engine(max_batch=4) serving 8 greedy requests of
             32 new tokens over the flat bf16 cache
  7 serve_kv the same model and requests through
             Engine(cache_dtype=float8_e4m3fn) (headed fp8 cache) and
             PagedEngine(page_size=16, cache_dtype=float8_e4m3fn); every
             page returns to the pool; tokens/s, peak device memory and
             KV bytes of each cache beside serve's; then each scores 8
             seeded (context, continuation) pairs through
             eval.loglikelihood(engine=...) (score_forward), seconds and
             scores as information, failing on a non-finite score
  8 serve_block the same model and requests through run(reqs,
             decode_block=8) in Engine (flat bf16 cache), Engine
             (cache_dtype=float8_e4m3fn, headed fp8 cache) and PagedEngine
             (fp8 pool, page size 16; each block's pages taken up front,
             its steps reading a static copy of the block table): the burst
             admission, step_block while requests wait, then the
             pipelined drain, each decode step of a block a replay of the
             captured CUDA graph of the step at its kv_window bucket;
             tokens/s beside serve's and serve_kv's decode_block=1 runs
             (a fresh engine, its captures counted in, then the same run
             on the engine whose graphs exist, which must give the same
             tokens), graphs captured and the seconds spent capturing,
             peak memory, the share of tokens equal to the decode_block=1
             runs (information: run schedules otherwise); fails unless
             every kernel of the path launched, each captured step
             launched its layout's KV append once a layer (the paged step
             also paged decode attention; counted at capture: a replay
             moves no counter), every page is back in the pool, and,
             after admitting 4 requests, 8 eager steps from a snapshot
             (the allocator included) equal one block of 8 from the
             restored snapshot bit for bit (tokens and cache bytes; for
             the paged pool each slot's K and V gathered through its own
             table, since a block's pages differ from eager steps')
  9 serve_w4a8 serve's model and requests with W4A8 prefill:
             Engine(max_batch=4, prefill_fmt="w4a8") over the flat bf16
             cache and PagedEngine(page_size=16, cache_dtype=fp8,
             prefill_fmt="w4a8"); W4A8 against exact prefill GEMM launches
             (every W4A8 launch on the 64-row int8 wgmma tiles) and the
             share of token streams equal to those of the same
             engine with nvfp4 prefill (serve, serve_kv); then the
             weight-cache GEMMs through the public mul_* entries with
             explicit solution ids (the autotuner's route) on one layer
 10 serve_hybrid the same dense weights quantized "hybrid" on the card
             (a quarter of each projection's columns, the most salient,
             kept bf16) through Engine(max_batch=4, fmt="hybrid") over the
             flat bf16 cache, serving the same 8 requests: tokens/s, peak
             memory and weight bytes beside serve's
 11 train    the same nvfp4 model trained for 3 steps on 513 seeded tokens
             (B = 1, T = 512): next-token cross-entropy, backward through
             mul_fp4_diff (the dequant kernel), SGD at 1e-3 on embed, the
             norms and lm_head (the global scales get their gradient but
             stay fixed; words and scales are frozen); loss per step, step
             time, peak memory
 12 serve_moe the full 32-layer Mixtral-8x7B (mxfp4 experts, nvfp4
             attention, random weights quantized on the card) through
             Engine(max_batch=4, forward_fn=moe.make_engine_forward(cfg))
             over the flat bf16 cache, serving the same 8 requests; prints
             the capacity drops of one 256-token chunk per layer; then the
             same model and requests through run(reqs, decode_block=8) as
             serve_block runs them (each captured step: grouped_mul three
             times a layer and the flat KV append once; tokens/s beside the
             decode_block=1 run, graphs, capture seconds, peak memory
             beside the eager run's, the 8-step snapshot check)
 13 load     models/loader.load_llama on the card: a 2-layer checkpoint at
             Llama-3-8B's widths (vocab 128256, tied embeddings), written
             by the script's own safetensors writer into a temporary
             directory in two flavours, dense bf16 and ModelOpt NVFP4
             (scales F8_E4M3), each loaded in nvfp4: every leaf bit for bit
             the same params built in memory (quantize_linear of the same
             weights on the card; the repack of the same bytes), again
             through the repack cache; Engine(max_batch=2) serving 2 prompts
             of 8 tokens over each loaded model gives the in-memory params'
             tokens; both load times
 14 serve_spec SpecEngine over serve's 32-layer Llama-3-8B (nvfp4) and
             the first 4 of its requests (32 new tokens, max_batch 4,
             gamma 11, adaptive): draft (a) 2 layers at the same widths
             over bf16 and over fp8 caches, draft (b) the target itself
             over bf16 caches, and draft (a) with force_accept = 1.0 (n_acc
             = g - 1 in every tick); each tick a replay of the CUDA graph
             of its (g, window), the launches of each captured tick
             counted (its layout's KV append once a layer a draft step and
             once a layer for the verify), every emitted token the target's
             score_forward argmax or within 2^-5 * max|logits| of it, a
             second run on the same engine the same tokens, one tick's
             replay bit for bit the eager tick from the same state (output
             and both caches' bytes), draft (b) accepting at least half of
             the cap ((g - 1) a slot a tick); tokens/s fresh and warm, ms a
             tick, accepted a tick, graphs and capture seconds beside
             Engine.run(decode_block=8) on the same requests (bf16, fp8)
 15 serve_parallel tensor and expert parallelism (parallel/tp.py,
             parallel/ep.py) on a one-rank NCCL process group (file store,
             device_id, so the communicator exists before any capture):
             the 32-layer Llama-3-8B through quantize_params_tp at tp = 1
             (random weights from seed 0, one dense layer at a time),
             the plain Engine and the TP Engine (make_tp_step,
             init_cache_tp) over that one unfused tree, serve's 8 requests
             over flat bf16 caches and the first 4 over headed fp8 caches,
             eager and run(decode_block=8): the TP Engine's tokens the
             plain Engine's bit for bit in both modes, its blocks checked
             as serve_block's (launches at capture, a second run, the
             8-step snapshot check); 8 eager steps of each engine timed and
             one block under torch.profiler (idle share, NCCL kernels and
             copies a step); the host time of one eager collective;
             make_tp_forward_sp on a (1, 512) prompt bit for bit
             make_tp_forward, mul_fp4_tp_rs over w_down at m = 8 and 512
             bit for bit mul_nvfp4_a16; the shard shapes a tp = 2 or 4
             rank launches (the seven Llama-3-8B projections through
             quantize_linear_tp and local_linear_tp, m = 8 and 512), each
             twice the same bits and within the GEMM tolerance of its twin,
             their columns or k-sum within it of the unsharded product,
             timed beside it; the EP Engine (make_ep_step,
             place_experts_ep at ep = 1) over serve_moe's Mixtral through
             run(decode_block=8), checked as serve_block's, its tokens the
             Mixtral Engine's bit for bit (serve_moe's run, or one here);
             the dense TP and SP training steps (make_tp_forward and
             make_tp_forward_sp over shard_dense_params at tp = 1) on a
             dense bf16 model at Llama-3-8B's widths cut to 2 layers, B =
             1, T = 512: loss and every gradient bit for bit the plain
             dense step's, step ms and peak memory beside it; the seconds
             of each part
 16 serve_pp pipeline parallelism (parallel/pp.py) on the one-rank NCCL
             group at pp = 1: serve's Llama-3-8B (nvfp4) cut to its first
             8 layers through place_params_pp; make_pp_step at n_micro 1,
             2 and 4 on B = 4
             over init_cache_pp, the first 32 tokens of serve's first 4
             prompts teacher-forced then 32 greedy tokens, each token the
             plain cacheless forward's argmax or within 2^-5 * max|logits|
             of it (counted against greedy_decode's), the launches a step,
             ms a step, one step under torch.profiler; make_pp_forward on
             (4, 128) tokens within the GEMM tolerance of the cacheless
             forward; then the Engine's fallback for a forward_fn without
             kv_window and write_mask (llama.forward at kv_window =
             max_seq_len) serving the first 4 requests eager and through
             run(decode_block=8) (one graph, no window key; checked as
             serve_block's), every token within the tie rule of the plain
             Engine's score_forward
 17 serve_cluster the cluster tier (models/cluster.py, models/rpc.py):
             (a) a Cluster of two Engine(max_batch=4) replicas over serve's
             32-layer Llama-3-8B (nvfp4) serving its 8 requests at
             decode_block=1 and 8, each twice (the second run's tokens the
             first's bit for bit), each replica's kernels counted apart,
             every token within the tie rule of the plain Engine's
             score_forward, tokens/s beside Engine(max_batch=8).run(
             decode_block=8) on the same requests; (b) subprocess replicas
             (rpc.SubprocessReplica, children spawned on the card) each
             building the model from seed 0 at Llama-3-8B widths cut to 2
             layers: a one-replica Cluster bit for bit Cluster([Engine])
             over rpc.replica_params of the same spec in this process
             (decode_block=1 and 8); two children serving the 8 requests
             with child 0 crashed after the first tick (fatal, replayed,
             respawned, revived; every token within the tie rule); a
             transient fault injected into a child (no respawn, no
             failure); each child's spawn-to-first-ping seconds (these two
             and (c)'s two start together), the median of 100 ping round
             trips, the seconds from the crash to the revival; the kernel
             library neither rebuilt nor rewritten by the children; (c)
             make_tp_cluster(dp=2, tp=1) over the same
             2-layer weights: two one-rank NCCL groups in two children on
             cuda:0, every token within the tie rule of the plain Engine
             over the same unfused tree; the seconds of each part
 18 profile  the decode step and one 256-token prefill tick under
             torch.profiler, in Engine (Llama, bf16; and over the headed
             fp8 cache), PagedEngine (Llama, fp8, page size 16), the
             hybrid Engine and the Mixtral Engine, all but the hybrid
             Engine also in a block of 10 decode steps through
             step_block, each step a graph replay,
             one 512-token prefill tick of the Llama Engine with nvfp4 and
             with W4A8 prefill and of the hybrid Engine, and one training
             step: kernels by device time, device kernels a step and the
             device's idle share (PERF.md section 5); a trace of ten decode
             steps that holds fewer than ten appends a layer lost records:
             it is taken again, up to three times, then the phase fails
 19 hybrid_layer (only when named) the hybrid GEMM alone at the seven
             unfused projections, m = 8, default tile and splits, L2-warm
             and L2-flushed: for an A/B against an older tree, which a
             copy of this script in that tree's checkout times
 20 fp4_layer (only when named) fp4_gemm's decode layer alone, the four
             Llama-3-8B projections at m = 8, default tile and splits,
             L2-warm, L2-flushed and as a CUDA graph: the same kind of A/B
 21 grouped_layer (only when named) one Mixtral-8x7B layer's three grouped
             calls at cap 8 (mxfp4, E = 8) through grouped_mul's defaults,
             every bucket row filled, warm and as a CUDA graph of the three;
             where the tree's grouped_mul takes `rows`, also the routed
             buckets of phase 3 with their rows: the same kind of A/B
 22 w4a8_layer (only when named) the W4A8 GEMM's tiles alone, the four
             Llama-3-8B projections (nvfp4): the 64-row tiles at m = 512
             and 2048, the 16-row tiles at m = 16 (plain) and 64 (weight
             cache) at their default splits, at block_n 64 and 128, plain
             and weight cache (pk_fp4_gemm_w4a8 and pk_fp4_gemm_w4a8_wc),
             bare launches on activations quantized beforehand, L2-warm,
             summed over the four, the 16-row ones also as a CUDA graph of
             the four: the same kind of A/B, also of copies of the tile
             bodies edited to find what bounds them (it checks no bits)
 23 hybrid_prefill_layer (only when named) the hybrid GEMM's 64-row
             tiles alone, the seven unfused projections at m = 512, the
             heuristic's tile, L2-warm, summed over the layer, with the
             dense columns alone (a launch with no FP4 columns) beside
             torch.matmul(a, wd[:k]) and the FP4 columns alone (fused_mul):
             the same kind of A/B
 24 append_layer (only when named) the KV writes alone, each as a CUDA
             graph of 20 launches: kv_append flat bf16 and headed bf16 and
             fp8, kv_append_paged fp8 (page size 16) and the torch glue it
             replaced, each _write_kv as the Llama block calls it (flat
             bf16, headed fp8, paged fp8; a decode step of 4 rows and a
             256-token chunk), and an empty kernel, the launch floor: the
             same kind of A/B, which a copy of this script in an older
             tree's checkout times
 25 fp4_wc_layer (only when named) the FP4 weight cache's 16-row tiles
             alone: the four Llama-3-8B projections (nvfp4) at m = 64
             through fused_mul with weight-cache ids 16x64 and 16x128 at
             their default splits, beside the plain 16-row tile, L2-warm
             and as a CUDA graph of the four: the same kind of A/B, also of
             copies of csrc/fp4_stream.cuh with another plan (it checks no
             bits)
 26 decode_attn_layer (only when named) decode attention alone, at the
             Engine's decode shape (B = 4, positions 274, 316, 177 and 108,
             window 512) and the kernels phase's (B = 8, S = 2048): flat
             bf16, headed fp8 and paged fp8 (page size 16), each as a CUDA
             graph of 32 launches, one a layer over its own cache, beside
             SDPA over the same bf16 K/V as a graph: the same kind of A/B,
             which a copy of this script in an older tree's checkout times
 27 hp_layer (only when named) the high-precision GEMM's tiles alone,
             the four Llama-3-8B projections (nvfp4, f32 A) through
             fused_mul with hp ids at their default splits: m = 8 at 16x64
             and 16x128, the weight cache at m = 64 (16x64), and the 64-row
             tiles at m = 2048 (64x128 and 64x64, plain and weight cache),
             L2-warm, L2-flushed and as a CUDA graph of the four, beside f32
             torch.matmul (TF32 off) warm and as a graph: the same kind of
             A/B, also of copies of the tile bodies edited to find what
             bounds them (it checks no bits)

Each engine run of phases 6-10 and 12-17 (and the weight-cache run of
phase 9, the training run of phase 11 and the sweep and table runs of
phase 4) sets
every kernel's launch count to 0 before it and fails if a kernel of its
path did not launch; an engine run also counts the launches inside decode
steps, per decode step (in the block runs of phases 8 and 12 per
captured step), and fails unless each decode step launched its layout's
KV append once a layer. The line
before the last is the card's `nvidia-smi` name and power limit, the one
before it a JSON object with each kernel's launches (summed over those
runs), max abs error, times, bound and library time (phases 3 and 4). The
last line is {"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}. With --record PATH, every measurement (per-shape GEMM rows
included) is also written there as JSON; with --parent-record PATH (another
tree's record, the parent commit's in an A/B call) each kernel row also
keeps that run's time as parent_ms. """

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import inspect
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from petit_kernel_tpu_torch import _cli as port_cli
from petit_kernel_tpu_torch import bench as port_bench
from petit_kernel_tpu_torch.models import eval as port_eval
from petit_kernel_tpu_torch.models import cluster as cluster_mod
from petit_kernel_tpu_torch.models import llama, loader, moe, paged, rpc
from petit_kernel_tpu_torch.models import serving
from petit_kernel_tpu_torch.ops import _build, autotune, gemm
from petit_kernel_tpu_torch.ops import layout
from petit_kernel_tpu_torch.ops.kernels import attention, fused, grouped
from petit_kernel_tpu_torch.ops.kernels import hybrid
from petit_kernel_tpu_torch.ops.solution import ElementB
from petit_kernel_tpu_torch.ops import solution as solution_mod
from petit_kernel_tpu_torch.numerics import reference as qref
from petit_kernel_tpu_torch.parallel import ep as ep_mod
from petit_kernel_tpu_torch.parallel import pp as pp_mod
from petit_kernel_tpu_torch.parallel import tp as tp_mod
from petit_kernel_tpu_torch.utils import benchlib

PHASES = ("device", "build", "kernels", "solutions", "parity", "serve",
          "serve_kv", "serve_block", "serve_w4a8", "serve_hybrid", "train",
          "serve_moe", "load", "serve_spec", "serve_parallel",
          "serve_pp", "serve_cluster", "profile", "hybrid_layer", "fp4_layer",
          "grouped_layer", "w4a8_layer", "hybrid_prefill_layer",
          "append_layer", "fp4_wc_layer", "decode_attn_layer", "hp_layer")
# run when --phases is not given: all but the nine A/B phases
DEFAULT_PHASES = PHASES[:-9]
# the four Llama-3-8B projections as (k, n): wqkv, wo, w_gateup, w_down
LLAMA8B_KN = ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096))
# the seven unfused ones (fmt="hybrid" does not fuse): wq, wk, wv, wo,
# w_gate, w_up, w_down
LLAMA8B_UNFUSED_KN = ((4096, 4096), (4096, 1024), (4096, 1024), (4096, 4096),
                      (4096, 14336), (4096, 14336), (14336, 4096))
MIXTRAL_8X7B = moe.MixtralConfig.mixtral_8x7b()
# a Mixtral-8x7B expert's projections as (k, n): w_gate and w_up, w_down
MIXTRAL_EXPERT_KN = ((4096, 14336), (14336, 4096))
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense tensor-core
# operations/s of bf16 and of int8 operands; `bound` below divides by them
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12
KERNELS = {
    "fp4_gemm": dict(route="cuda",
                     source="petit_kernel_tpu_torch/csrc/fp4_gemm.cu",
                     replaces="petit_kernel_tpu/ops/kernels/fused.py:195",
                     wrapper=fused.fused_mul),
    # fused_mul's 64-row (prefill) tiles, the wgmma body: their own kernel,
    # counted apart (fused_mul.wgmma_launches) and inside fp4_gemm's count
    "fp4_gemm_prefill": dict(
        route="cuda", source="petit_kernel_tpu_torch/csrc/fp4_wgmma.cuh",
        replaces="petit_kernel_tpu/ops/kernels/fused.py:195",
        wrapper=fused.fused_mul, counter="wgmma_launches"),
    # the three decode entries launch one split-KV body,
    # csrc/decode_attention.cuh (through decode_attention.cu and
    # paged_decode_attention.cu)
    "decode_attention": dict(
        route="cuda", source="petit_kernel_tpu_torch/csrc/decode_attention.cuh",
        replaces="petit_kernel_tpu/ops/kernels/attention.py:169",
        wrapper=attention.decode_attention_contiguous),
    "prefill_attention": dict(
        route="cuda", source="petit_kernel_tpu_torch/csrc/prefill_attention.cu",
        replaces="petit_kernel_tpu/ops/kernels/attention.py:445",
        wrapper=attention.flash_prefill_attention),
    "kv_append": dict(route="cuda",
                      source="petit_kernel_tpu_torch/csrc/kv_append.cu",
                      replaces="petit_kernel_tpu/ops/kernels/attention.py:683",
                      wrapper=attention.kv_append),
    "decode_attention_headed": dict(
        route="cuda",
        source="petit_kernel_tpu_torch/csrc/decode_attention.cuh",
        replaces="petit_kernel_tpu/ops/kernels/attention.py:87",
        wrapper=attention.decode_attention_contiguous_headed),
    "paged_decode_attention": dict(
        route="cuda",
        source="petit_kernel_tpu_torch/csrc/decode_attention.cuh",
        replaces="petit_kernel_tpu/ops/kernels/attention.py:87",
        wrapper=attention.paged_decode_attention),
    "prefill_attention_headed": dict(
        route="cuda",
        source="petit_kernel_tpu_torch/csrc/paged_prefill_attention.cu",
        replaces="petit_kernel_tpu/ops/kernels/attention.py:445",
        wrapper=attention.flash_prefill_headed),
    "paged_prefill_attention": dict(
        route="cuda",
        source="petit_kernel_tpu_torch/csrc/paged_prefill_attention.cu",
        replaces="petit_kernel_tpu/ops/kernels/attention.py:504",
        wrapper=attention.flash_prefill_paged),
    "kv_append_headed": dict(
        route="cuda", source="petit_kernel_tpu_torch/csrc/kv_append.cu",
        replaces="petit_kernel_tpu/ops/kernels/attention.py:695",
        wrapper=attention.kv_append_headed),
    # the paged pool's write: an XLA scatter in the JAX package, the append
    # body of the two rows above in the port
    "kv_append_paged": dict(
        route="cuda", source="petit_kernel_tpu_torch/csrc/kv_append.cu",
        replaces="petit_kernel_tpu/models/paged.py:106",
        wrapper=attention.kv_append_paged),
    "grouped_fp4_gemm": dict(
        route="cuda", source="petit_kernel_tpu_torch/csrc/grouped_fp4_gemm.cu",
        replaces="petit_kernel_tpu/ops/kernels/grouped.py:26",
        wrapper=grouped.grouped_mul),
    # an engine reaches only its 64-row tiles, the int8 wgmma body
    # csrc/w4a8_wgmma.cuh (fused_mul_w4a8.wgmma_launches; serve_w4a8 checks
    # that every launch of its runs went there)
    "fp4_gemm_w4a8": dict(
        route="cuda", source="petit_kernel_tpu_torch/csrc/fp4_gemm_w4a8.cu",
        replaces="petit_kernel_tpu/ops/kernels/fused.py:482",
        wrapper=fused.fused_mul_w4a8),
    "fp4_gemm_w4a8_wc": dict(
        route="cuda", source="petit_kernel_tpu_torch/csrc/fp4_gemm_w4a8.cu",
        replaces="petit_kernel_tpu/ops/kernels/fused.py:526",
        wrapper=fused.fused_mul_w4a8_wc),
    "fp4_gemm_wc": dict(route="cuda",
                        source="petit_kernel_tpu_torch/csrc/fp4_gemm.cu",
                        replaces="petit_kernel_tpu/ops/kernels/fused.py:259",
                        wrapper=fused.fused_mul_wc),
    # fused_mul_wc's 16-row tiles, the stream body at 4 m-tiles a CTA:
    # their own kernel, counted apart (fused_mul_wc.stream_launches) and
    # inside fp4_gemm_wc's count
    "fp4_gemm_wc_16row": dict(
        route="cuda", source="petit_kernel_tpu_torch/csrc/fp4_stream.cuh",
        replaces="petit_kernel_tpu/ops/kernels/fused.py:259",
        wrapper=fused.fused_mul_wc, counter="stream_launches"),
    "fp4_gemm_hp": dict(route="cuda",
                        source="petit_kernel_tpu_torch/csrc/fp4_gemm_hp.cu",
                        replaces="petit_kernel_tpu/ops/kernels/fused.py:230",
                        wrapper=fused.fused_mul_hp),
    "fp4_gemm_hp_wc": dict(
        route="cuda", source="petit_kernel_tpu_torch/csrc/fp4_gemm_hp.cu",
        replaces="petit_kernel_tpu/ops/kernels/fused.py:302",
        wrapper=fused.fused_mul_hp_wc),
    # fused_mul_hp_wc's 16-row tiles, the stream body's f32 form at 2
    # m-tiles a CTA: their own kernel, counted apart
    # (fused_mul_hp_wc.stream_launches) and inside fp4_gemm_hp_wc's count
    "fp4_gemm_hp_wc_16row": dict(
        route="cuda", source="petit_kernel_tpu_torch/csrc/fp4_stream.cuh",
        replaces="petit_kernel_tpu/ops/kernels/fused.py:302",
        wrapper=fused.fused_mul_hp_wc, counter="stream_launches"),
    # both hp wrappers' 64-row tiles, the register-A wgmma body at 1 and 2
    # m-tiles a CTA: their own kernel, counted apart (.wgmma_launches) and
    # inside fp4_gemm_hp's and fp4_gemm_hp_wc's counts
    "fp4_gemm_hp_prefill": dict(
        route="cuda", source="petit_kernel_tpu_torch/csrc/fp4_hp_wgmma.cuh",
        replaces="petit_kernel_tpu/ops/kernels/fused.py:230",
        wrapper=fused.fused_mul_hp, counter="wgmma_launches"),
    "fp4_gemm_hp_wc_prefill": dict(
        route="cuda", source="petit_kernel_tpu_torch/csrc/fp4_hp_wgmma.cuh",
        replaces="petit_kernel_tpu/ops/kernels/fused.py:302",
        wrapper=fused.fused_mul_hp_wc, counter="wgmma_launches"),
    "fp4_dequant": dict(route="cuda",
                        source="petit_kernel_tpu_torch/csrc/fp4_dequant.cu",
                        replaces="petit_kernel_tpu/ops/kernels/fused.py:718",
                        wrapper=fused.dequant_tpu_layout),
    "hybrid_gemm": dict(route="cuda",
                        source="petit_kernel_tpu_torch/csrc/hybrid_gemm.cu",
                        replaces="petit_kernel_tpu/ops/kernels/hybrid.py:34",
                        wrapper=hybrid.hybrid_mul),
}
# the microbatch counts of serve_pp's pipelined decode
PP_MICRO = (1, 2, 4)
# the layers of serve's model that serve_pp's pipelined decode and forward
# run: their eager steps wait on the host, so depth sets the phase's time
PP_DEPTH = 8
# the kernels each engine run of phases 6-10 and 12-17 (and the
# weight-cache run of phase 9 and the training run of phase 11) must launch
PATHS = {
    "serve bf16 Engine": ("fp4_gemm", "fp4_gemm_prefill", "decode_attention",
                          "prefill_attention", "kv_append"),
    "serve_kv fp8 Engine": ("fp4_gemm", "fp4_gemm_prefill",
                            "decode_attention_headed",
                            "prefill_attention_headed", "kv_append_headed"),
    "serve_kv fp8 PagedEngine": ("fp4_gemm", "fp4_gemm_prefill",
                                 "paged_decode_attention",
                                 "paged_prefill_attention", "kv_append_paged"),
    "serve_moe Mixtral Engine": ("grouped_fp4_gemm", "fp4_gemm",
                                 "fp4_gemm_prefill", "decode_attention",
                                 "prefill_attention", "kv_append"),
    "serve_w4a8 bf16 Engine": ("fp4_gemm_w4a8", "fp4_gemm",
                               "decode_attention", "prefill_attention",
                               "kv_append"),
    "serve_w4a8 fp8 PagedEngine": ("fp4_gemm_w4a8", "fp4_gemm",
                                   "paged_decode_attention",
                                   "paged_prefill_attention",
                                   "kv_append_paged"),
    "gemm_api weight-cache ids": ("fp4_gemm_wc", "fp4_gemm_wc_16row",
                                  "fp4_gemm_w4a8_wc"),
    "serve_block bf16 Engine": ("fp4_gemm", "fp4_gemm_prefill",
                                "decode_attention", "prefill_attention",
                                "kv_append"),
    "serve_block fp8 Engine": ("fp4_gemm", "fp4_gemm_prefill",
                               "decode_attention_headed",
                               "prefill_attention_headed", "kv_append_headed"),
    "serve_block fp8 PagedEngine": ("fp4_gemm", "fp4_gemm_prefill",
                                    "paged_decode_attention",
                                    "paged_prefill_attention",
                                    "kv_append_paged"),
    "serve_moe Mixtral Engine decode_block=8": (
        "grouped_fp4_gemm", "fp4_gemm", "fp4_gemm_prefill",
        "decode_attention", "prefill_attention", "kv_append"),
    "serve_hybrid bf16 Engine": ("hybrid_gemm", "decode_attention",
                                 "prefill_attention", "kv_append"),
    "train nvfp4 Llama": ("fp4_gemm", "fp4_gemm_prefill", "fp4_dequant"),
    "load dense bf16 checkpoint nvfp4 Engine": (
        "fp4_gemm", "fp4_gemm_prefill", "decode_attention",
        "prefill_attention", "kv_append"),
    "load ModelOpt NVFP4 checkpoint nvfp4 Engine": (
        "fp4_gemm", "fp4_gemm_prefill", "decode_attention",
        "prefill_attention", "kv_append"),
    "serve_spec bf16 SpecEngine draft 2-layer": (
        "fp4_gemm", "fp4_gemm_prefill", "decode_attention",
        "prefill_attention", "kv_append"),
    "serve_spec fp8 SpecEngine draft 2-layer": (
        "fp4_gemm", "fp4_gemm_prefill", "decode_attention_headed",
        "prefill_attention_headed", "kv_append_headed"),
    "serve_spec bf16 SpecEngine draft = target": (
        "fp4_gemm", "fp4_gemm_prefill", "decode_attention",
        "prefill_attention", "kv_append"),
    "serve_spec bf16 SpecEngine draft 2-layer force_accept=1": (
        "fp4_gemm", "fp4_gemm_prefill", "decode_attention",
        "prefill_attention", "kv_append"),
    "serve_spec bf16 Engine decode_block=8": (
        "fp4_gemm", "fp4_gemm_prefill", "decode_attention",
        "prefill_attention", "kv_append"),
    "serve_spec fp8 Engine decode_block=8": (
        "fp4_gemm", "fp4_gemm_prefill", "decode_attention_headed",
        "prefill_attention_headed", "kv_append_headed"),
    "serve_parallel bf16 Engine": ("fp4_gemm", "fp4_gemm_prefill",
                                   "decode_attention", "prefill_attention",
                                   "kv_append"),
    "serve_parallel bf16 TP Engine": ("fp4_gemm", "fp4_gemm_prefill",
                                      "decode_attention", "prefill_attention",
                                      "kv_append"),
    "serve_parallel bf16 TP Engine decode_block=8": (
        "fp4_gemm", "fp4_gemm_prefill", "decode_attention",
        "prefill_attention", "kv_append"),
    "serve_parallel bf16 Engine decode_block=8": (
        "fp4_gemm", "fp4_gemm_prefill", "decode_attention",
        "prefill_attention", "kv_append"),
    "serve_parallel fp8 Engine": ("fp4_gemm", "fp4_gemm_prefill",
                                  "decode_attention_headed",
                                  "prefill_attention_headed",
                                  "kv_append_headed"),
    "serve_parallel fp8 TP Engine": ("fp4_gemm", "fp4_gemm_prefill",
                                     "decode_attention_headed",
                                     "prefill_attention_headed",
                                     "kv_append_headed"),
    "serve_parallel fp8 TP Engine decode_block=8": (
        "fp4_gemm", "fp4_gemm_prefill", "decode_attention_headed",
        "prefill_attention_headed", "kv_append_headed"),
    "serve_parallel fp8 Engine decode_block=8": (
        "fp4_gemm", "fp4_gemm_prefill", "decode_attention_headed",
        "prefill_attention_headed", "kv_append_headed"),
    "serve_parallel EP Engine decode_block=8": (
        "grouped_fp4_gemm", "fp4_gemm", "fp4_gemm_prefill",
        "decode_attention", "prefill_attention", "kv_append"),
    "serve_parallel Mixtral Engine decode_block=8": (
        "grouped_fp4_gemm", "fp4_gemm", "fp4_gemm_prefill",
        "decode_attention", "prefill_attention", "kv_append"),
    **{f"serve_pp PP decode n_micro={n}": ("fp4_gemm", "decode_attention",
                                           "kv_append") for n in PP_MICRO},
    "serve_pp PP forward": ("fp4_gemm", "fp4_gemm_prefill"),
    "serve_pp fallback Engine": ("fp4_gemm", "fp4_gemm_prefill",
                                 "decode_attention", "prefill_attention",
                                 "kv_append"),
    "serve_pp fallback Engine decode_block=8": (
        "fp4_gemm", "fp4_gemm_prefill", "decode_attention",
        "prefill_attention", "kv_append"),
    **{f"serve_cluster in-process Cluster decode_block={b}": (
        "fp4_gemm", "fp4_gemm_prefill", "decode_attention",
        "prefill_attention", "kv_append") for b in (1, 8)},
    "solutions sweep": ("fp4_gemm", "fp4_gemm_wc", "fp4_gemm_wc_16row",
                        "fp4_gemm_hp", "fp4_gemm_hp_wc",
                        "fp4_gemm_hp_wc_16row", "fp4_gemm_hp_prefill",
                        "fp4_gemm_hp_wc_prefill"),
}
# the launches a layer each captured decode step of a serve_block or
# serve_moe block run must count, beyond its path's KV append (once)
CAPTURED_PER_LAYER = {
    "serve_block fp8 PagedEngine": {"paged_decode_attention": 1},
    "serve_moe Mixtral Engine decode_block=8": {"grouped_fp4_gemm": 3},
    "serve_parallel EP Engine decode_block=8": {"grouped_fp4_gemm": 3},
}
FP8 = torch.float8_e4m3fn


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_device(rec):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA card")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[-1]
    rec["device"] = dict(name=torch.cuda.get_device_name(0),
                         count=torch.cuda.device_count(),
                         torch=torch.__version__, cuda=torch.version.cuda,
                         nvcc=ver, smi=smi_line(),
                         python=sys.version.split()[0])
    for k, v in rec["device"].items():
        log(f"[device] {k}: {v}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _ptxas_table(text: str) -> dict:
    """Registers and spill bytes of every kernel in ptxas -v output, by a
    short name (`hybrid_gemm_kernel<64, 128>`), and the kernels a C7515
    warning (wgmma serialized) names."""
    def short(mangled):
        # _Z[N] <length><name> ... I<template arguments>E: the last name
        if not mangled.startswith("_Z"):
            return mangled[:90]
        rest, names = mangled[3 if mangled.startswith("_ZN") else 2:], []
        while rest[:1].isdigit():
            digits = re.match(r"\d+", rest)[0]
            names.append(rest[len(digits):len(digits) + int(digits)])
            rest = rest[len(digits) + int(digits):]
        if not names:
            return mangled[:90]
        args = re.match(r"I((?:Li-?\d+E)+)E", rest)
        if args:
            return f"{names[-1]}<{', '.join(re.findall(r'Li(-?[0-9]+)E', args[1]))}>"
        return names[-1] + (rest[:40] if rest.startswith("I") else "")
    table, name = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line and "'" in line:
            name = short(line.split("'")[1])
            table[name] = dict(registers=None, spill_stores=None,
                               spill_loads=None, c7515=False)
        elif name and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            table[name].update(spill_stores=int(st), spill_loads=int(ld))
        elif name and re.search(r"Used \d+ registers", line):
            table[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line)[1])
        if "C7515" in line or "wgmma.mma_async instructions are serialized" in line:
            for mangled in re.findall(r"'(_Z\w+)'", line):
                table.setdefault(short(mangled), {})["c7515"] = True
    return table


def _hgmma_waits(lib, stem: str) -> dict:
    """{kernel<BN, G>: (HGMMAs, waits for no wgmma group in flight)} in the
    SASS of the kernels of `lib` whose name holds `stem`. ptxas may
    serialize a body's wgmmas without a message (it did for an in-flight
    group carried across a loop's back-edge); then every HGMMA is followed
    by such a wait."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            args = re.search(r"ILi(\d+)ELi(\d+)E", m[1])
            name = (f"{stem}<{args[1]}, {args[2]}>"
                    if stem in m[1] and args else None)
            if name:
                counts[name] = [0, 0]
        elif name:
            counts[name][0] += "HGMMA" in line
            counts[name][1] += "WARPGROUP.DEPBAR.LE gsb0, 0x0" in line
    return {k: tuple(v) for k, v in counts.items()}


def phase_build(rec):
    info = _build.build()
    _build.library()
    rec["build_seconds"] = info.seconds
    log(f"[build] {info.path.name} in {info.seconds:.1f} s "
        f"({'reused' if info.seconds == 0 else 'compiled'})")
    rec["ptxas"] = _ptxas_table(info.log)
    for name, p in rec["ptxas"].items():
        log(f"[build] ptxas {name}: {p.get('registers')} registers, spill "
            f"stores {p.get('spill_stores')} and loads {p.get('spill_loads')}"
            f" bytes{', C7515 (wgmma serialized)' if p.get('c7515') else ''}")
    # the W4A8 16-row tiles' four instances (csrc/w4a8_stream.cuh), plain
    # (G = 1) and weight cache (G = 4) at block_n 64 and 128
    stream = {name: p for name, p in rec["ptxas"].items()
              if name.startswith("w4a8_stream_kernel<")}
    if info.log and len(stream) != 4:
        raise AssertionError(f"build: ptxas compiled {sorted(stream)}, not "
                             "the four w4a8_stream_kernel instances")
    for name, p in sorted(stream.items()):
        log(f"[build] W4A8 16-row stream body {name}: {p.get('registers')} "
            f"registers, spill {p.get('spill_stores')}/{p.get('spill_loads')}"
            f" bytes, C7515 {'yes' if p.get('c7515') else 'no'}")
    # the FP4 16-row tiles of fp4_gemm.cu (csrc/fp4_stream.cuh), plain (G =
    # 1) and weight cache (G = 4) at block_n 64 and 128
    fp4 = {name: p for name, p in rec["ptxas"].items()
           if name.startswith("fp4_stream_kernel<")}
    if info.log and len(fp4) != 4:
        raise AssertionError(f"build: ptxas compiled {sorted(fp4)}, not "
                             "the four fp4_stream_kernel instances")
    for name, p in sorted(fp4.items()):
        log(f"[build] FP4 16-row stream body {name}: {p.get('registers')} "
            f"registers, spill {p.get('spill_stores')}/{p.get('spill_loads')}"
            f" bytes")
    # the high-precision 16-row tiles of fp4_gemm_hp.cu (the f32 form of
    # csrc/fp4_stream.cuh), plain (G = 1) and weight cache (G = 2) at
    # block_n 64 and 128
    hp = {name: p for name, p in rec["ptxas"].items()
          if name.startswith("fp4_hp_stream_kernel<")}
    if info.log and len(hp) != 4:
        raise AssertionError(f"build: ptxas compiled {sorted(hp)}, not "
                             "the four fp4_hp_stream_kernel instances")
    for name, p in sorted(hp.items()):
        log(f"[build] high-precision 16-row stream body {name}: "
            f"{p.get('registers')} registers, spill {p.get('spill_stores')}/"
            f"{p.get('spill_loads')} bytes")
    # the high-precision 64-row tiles (csrc/fp4_hp_wgmma.cuh), plain (G = 1)
    # and weight cache (G = 2) at block_n 64 and 128: a spill or a
    # serialized wgmma fails the build
    hpw = {name: p for name, p in rec["ptxas"].items()
           if name.startswith("fp4_hp_wgmma_kernel<")}
    if info.log and len(hpw) != 4:
        raise AssertionError(f"build: ptxas compiled {sorted(hpw)}, not "
                             "the four fp4_hp_wgmma_kernel instances")
    for name, p in sorted(hpw.items()):
        log(f"[build] high-precision 64-row wgmma body {name}: "
            f"{p.get('registers')} registers, spill {p.get('spill_stores')}/"
            f"{p.get('spill_loads')} bytes, C7515 "
            f"{'yes' if p.get('c7515') else 'no'}")
        if p.get("spill_stores") or p.get("spill_loads") or p.get("c7515"):
            raise AssertionError(f"build: {name} spills or serializes its "
                                 f"wgmmas: {p}")
    waits = _hgmma_waits(info.path, "fp4_hp_wgmma_kernel")
    rec["hp_wgmma_sass"] = waits
    if len(waits) != 4:
        raise AssertionError(f"build: SASS of {sorted(waits)}, not the four "
                             "fp4_hp_wgmma_kernel instances")
    for name, (hgmma, wait0) in sorted(waits.items()):
        log(f"[build] {name} SASS: {hgmma} HGMMA, {wait0} waits for no "
            "group in flight")
        if wait0 >= hgmma:
            raise AssertionError(f"build: ptxas serialized the wgmmas of "
                                 f"{name}")
    # the split-KV decode body (csrc/decode_attention.cuh), <d, fp8, paged>:
    # flat bf16 at d 64 and 128, headed or paged bf16 and fp8 at both
    dec = {name: p for name, p in rec["ptxas"].items()
           if name.startswith("decode_split_kernel<")}
    if info.log and len(dec) != 6:
        raise AssertionError(f"build: ptxas compiled {sorted(dec)}, not the "
                             "six decode_split_kernel instances")
    for name, p in sorted(dec.items()):
        log(f"[build] decode attention body {name}: {p.get('registers')} "
            f"registers, spill {p.get('spill_stores')}/{p.get('spill_loads')}"
            f" bytes")


def _close(name, got, want, rtol, atol):
    """|got - want| <= rtol*|want| + atol; returns max abs err."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bound = rtol * w.abs() + atol
    if not torch.isfinite(g).all() or bool((err > bound).any()):
        raise AssertionError(f"{name}: max abs err {err.max().item():.3e} "
                             f"exceeds rtol {rtol} / atol {float(atol):.3e}")
    return err.max().item()


def bound(nbytes: float, flops: float, ops_per_s: float = BF16_FLOP_PER_S
          ) -> dict:
    """The least time the card could take for a call that moves `nbytes`
    (each input read once, each output written once) and does `flops`
    operations: the larger of the two over HBM_BYTES_PER_S and the peak of
    the operands' type (BF16_FLOP_PER_S, or INT8_OP_PER_S for int8
    products), and which of the two it is."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / ops_per_s
    return dict(bound_ms=max(t_b, t_f) * 1e3,
                bound_by="bytes" if t_b >= t_f else "operations")


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _decode_work(q, pos, Hkv, kv_elt, page_size=None):
    """Bytes and operations one decode-attention call needs: q in and out,
    the K and V rows of positions <= pos[b] (and their block-table entries
    when paged); QK and PV at 2 operations a multiply-add."""
    B, H, d = q.shape
    n = int((pos.long() + 1).sum())
    nbytes = 2 * _nbytes(q) + 2 * n * Hkv * d * kv_elt + _nbytes(pos)
    if page_size:
        nbytes += 4 * int(((pos.long() + page_size) // page_size).sum())
    return nbytes, 4 * H * d * n


def _prefill_work(q, pos0, Hkv, kv_elt, page_size=None):
    """As _decode_work for a causal chunk: query t of row b at pos0[b] + t
    reads the positions <= pos0[b] + t."""
    B, T, H, d = q.shape
    p0 = pos0.long()
    n_kv = int((p0 + T).sum())
    pairs = int((T * p0).sum()) + B * T * (T + 1) // 2
    nbytes = 2 * _nbytes(q) + 2 * n_kv * Hkv * d * kv_elt + _nbytes(pos0)
    if page_size:
        nbytes += 4 * int(((p0 + T + page_size - 1) // page_size).sum())
    return nbytes, 4 * H * d * pairs


def _append_work(rows, Hkv, d, kv_elt, index_bytes):
    """A KV write of `rows` (b, t) tokens: their bf16 K and V read once and
    their cache rows written once, and `index_bytes` of positions, mask
    and block-table entries read once; no arithmetic worth counting."""
    return 2 * rows * Hkv * d * (2 + kv_elt) + index_bytes, 0


def _sdpa(q_bhtd, k_bhsd, v_bhsd, mask_bts):
    """The library yardstick of the attention kernels: one
    scaled_dot_product_attention call with the row's boolean mask."""
    return torch.nn.functional.scaled_dot_product_attention(
        q_bhtd, k_bhsd, v_bhsd, attn_mask=mask_bts[:, None], enable_gqa=True)


def _decode_sdpa(q, k_bhsd, v_bhsd, mask, label):
    """The decode rows' library yardstick, labelled by layout: one
    scaled_dot_product_attention call with the boolean position mask
    (B, 1, 1, S), over K/V as given (`label`) and over contiguous copies;
    back-to-back mean (ms) and a CUDA graph of 20 calls (graph_ms)."""
    out = {}
    for name, k, v in ((label, k_bhsd, v_bhsd),
                       ("contiguous (B, Hkv, S, d) bf16",
                        k_bhsd.contiguous(), v_bhsd.contiguous())):
        call = (lambda k=k, v=v: _sdpa(q[:, :, None], k, v, mask))
        out[name] = dict(ms=cuda_ms(call), graph_ms=_graph_ms(call),
                         mask="boolean (B, 1, 1, S): p <= pos[b]")
    return out


def _decode_mask(pos, S, window):
    p = torch.arange(S, device=pos.device)
    return ((p[None] <= pos.long()[:, None]) & (p[None] < window))[:, None]


def _prefill_mask(pos0, T, S):
    p = torch.arange(S, device=pos0.device)
    qp = pos0.long()[:, None] + torch.arange(T, device=pos0.device)[None]
    return p[None, None] <= qp[:, :, None]


# the serving shapes of the prefill kernels: one 512-token chunk of one
# sequence (B = 1, H = 32, Hkv = 8, d = 128) at the start of its prompt
# (window 512) and late in it (pos0 1536, window 2048)
SERVING_PREFILL = ((0, 512), (1536, 2048))


def _prefill_serving(res, rows, gen, name, tag, kernel, twin, library,
                     kv_elt, block, page_size=None):
    """One prefill kernel at SERVING_PREFILL: kernel(q, pos0, ns) against
    twin(q, pos0, ns) at 2^-7, with CUDA-event times of both and of
    library(q, window, mask) (one scaled_dot_product_attention call over
    bf16 K/V), the kernel's graph time (_cold_ms) and the bound of the
    work (_prefill_work). ns = window / block. Kept as rows and as the
    kernel's "serving" entry."""
    H, Hkv, d, T = 32, 8, 128, 512
    out = {}
    for p0, window in SERVING_PREFILL:
        q = torch.randn((1, T, H, d), generator=gen, device=gen.device).to(
            torch.bfloat16)
        pos0 = torch.tensor([p0], dtype=torch.int32, device=gen.device)
        ns = window // block
        got, want = kernel(q, pos0, ns), twin(q, pos0, ns)
        torch.cuda.synchronize()
        at = (f"{tag} B=1 T={T} pos0={p0} window={window} H={H} Hkv={Hkv} "
              f"d={d}")
        e = _close(f"{name} {at}", got, want, 2 ** -7, 2 ** -7)
        mask = _prefill_mask(pos0, T, window)
        t_k = cuda_ms(lambda: kernel(q, pos0, ns))
        t_g = _cold_ms([lambda: kernel(q, pos0, ns)])
        t_p = cuda_ms(lambda: twin(q, pos0, ns), iters=3)
        t_l = cuda_ms(lambda: library(q, window, mask))
        row = dict(kernel=name, variant=at, max_abs_err=e, ms=t_k,
                   graph_ms=t_g, plain_ms=t_p, library_ms=t_l,
                   **bound(*_prefill_work(q, pos0, Hkv, kv_elt,
                                          page_size=page_size)))
        rows.append(row)
        log(f"[kernels] {name} {at} err={e:.2e} kernel={t_k:.4f} ms "
            f"graph={t_g:.4f} ms plain={t_p:.4f} ms sdpa={t_l:.4f} ms "
            f"bound={row['bound_ms']:.4f} ms ({row['bound_by']})")
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], e)
        out[f"pos0={p0}"] = {k: row[k] for k in (
            "ms", "graph_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")}
    res[name]["serving"] = out


def _split_sweep(layer, counts=range(1, 9)):
    """fused_mul's 16-row tiles at each split count in `counts` for the
    four Llama-3-8B projections at m = 8 (layer: (a, words, st, gs, sid,
    deq) each): per projection L2-warm and L2-flushed, and the four as one
    CUDA graph (cold weights), each count's output against the one-split
    output at the GEMM tolerance."""
    out = []
    for sf in counts:
        entry = dict(splits=sf, projections=[])
        for a, words, st, gs, sid, _ in layer:
            n = words.shape[1]
            call = (lambda: fused.fused_mul(a, words, st, gs, sid=sid,
                                            splits=sf))
            one = fused.fused_mul(a, words, st, gs, sid=sid, splits=1)
            _close(f"sweep splits={sf} n={n}", call(), one, 2 ** -7,
                   2 ** -8 * one.float().abs().max())
            entry["projections"].append(dict(
                k=a.shape[1], n=n, warm_ms=cuda_ms(call),
                flushed_ms=_flushed_ms(call)))
        entry["warm_ms"] = sum(p["warm_ms"] for p in entry["projections"])
        entry["flushed_ms"] = sum(p["flushed_ms"]
                                  for p in entry["projections"])
        entry["graph_ms"] = 4 * _cold_ms([(lambda c=c: fused.fused_mul(
            c[0], c[1], c[2], c[3], sid=c[4], splits=sf)) for c in layer])
        out.append(entry)
        log(f"[kernels] gemm sweep splits={sf}: " + ", ".join(
            f"n={p['n']} k={p['k']} {p['warm_ms']:.4f}/"
            f"{p['flushed_ms']:.4f}" for p in entry["projections"])
            + f" ms warm/flushed; layer {entry['warm_ms']:.4f} warm, "
            f"{entry['flushed_ms']:.4f} flushed, {entry['graph_ms']:.4f} "
            "graph")
    return out


def phase_kernels(rec):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    rows, res = [], {}
    # --- fused FP4 GEMM -----------------------------------------------------
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err_g = 0.0
    sums = dict(ms=0.0, flushed_ms=0.0, plain_ms=0.0, library_ms=0.0,
                library_flushed_ms=0.0, nbytes=0, flops=0)
    layer = []          # nvfp4 m = 8: (a, words, st, gs, sid, deq) each
    for fmt in ("nvfp4", "nvfp4p2z"):
        quant = (qref.quantize_nvfp4 if fmt == "nvfp4"
                 else qref.quantize_nvfp4_pow2z)
        for k, n in LLAMA8B_KN:
            w = torch.randn((n, k), generator=gen, device=dev) / math.sqrt(k)
            qw, sc, gs = quant(w)
            words = layout.repack_fp4_weights(qw, n, k)
            st = layout.process_fp4_scales(sc, n, k, group_size=16)
            gs = gs.reshape(1)
            deq = (layout.dequant_from_tpu_layout(words, st, n, k)
                   * gs).to(torch.bfloat16)
            for m in (1, 8, 256):
                a = torch.randn((m, k), generator=gen, device=dev).to(
                    torch.bfloat16)
                sid = solution_mod.choose_default_solution(m, n, k,
                                                           ElementB.NVFP4)
                splits = fused.stream_splits(m, n, 0, words.shape[0] * 8,
                                             sid.block_m, sid.block_n,
                                             sms)[0]
                got = fused.fused_mul(a, words, st, gs, sid=sid)
                again = fused.fused_mul(a, words, st, gs, sid=sid)
                want = fused.fused_mul_reference(a, words, st, gs, sid=sid)
                torch.cuda.synchronize()
                what = f"gemm {fmt} m={m} k={k} n={n} splits={splits}"
                if not torch.equal(got.view(torch.int16),
                                   again.view(torch.int16)):
                    raise AssertionError(f"{what}: two launches differ")
                e = _close(what, got, want, 2 ** -7,
                           2 ** -8 * want.float().abs().max())
                call = (lambda: fused.fused_mul(a, words, st, gs, sid=sid))
                lib = (lambda: torch.matmul(a, deq))
                t_k, t_kf = cuda_ms(call), _flushed_ms(call)
                t_p = cuda_ms(lambda: fused.fused_mul_reference(
                    a, words, st, gs, sid=sid), iters=5)
                t_l, t_lf = cuda_ms(lib), _flushed_ms(lib)
                nbytes = _nbytes(words, st, gs, a, got)
                flops = 2 * m * n * k
                rows.append(dict(kernel="fp4_gemm", fmt=fmt, m=m, k=k, n=n,
                                 tile=[sid.block_m, sid.block_n],
                                 splits=splits, max_abs_err=e, ms=t_k,
                                 flushed_ms=t_kf, plain_ms=t_p,
                                 library_ms=t_l, library_flushed_ms=t_lf,
                                 **bound(nbytes, flops)))
                log(f"[kernels] gemm {fmt:8s} m={m:3d} k={k:5d} n={n:5d} "
                    f"tile={sid.block_m}x{sid.block_n} splits={splits} "
                    f"err={e:.2e}, repeatable; kernel={t_k:.4f} ms "
                    f"(flushed {t_kf:.4f}) plain={t_p:.4f} ms "
                    f"matmul={t_l:.4f} ms (flushed {t_lf:.4f}) "
                    f"bound={rows[-1]['bound_ms']:.4f} ms")
                err_g = max(err_g, e)
                if fmt == "nvfp4" and m == 8:
                    for key, v in (("ms", t_k), ("flushed_ms", t_kf),
                                   ("plain_ms", t_p), ("library_ms", t_l),
                                   ("library_flushed_ms", t_lf),
                                   ("nbytes", nbytes), ("flops", flops)):
                        sums[key] += v
                    layer.append((a, words, st, gs, sid, deq))
            del deq
    # the four projections as one decode layer: a CUDA graph of the four
    # launches (136 MB of weights, so each finds its own cold), against
    # the four matmuls the same way; then the split sweep
    graph_ms = 4 * _cold_ms([(lambda c=c: fused.fused_mul(
        c[0], c[1], c[2], c[3], sid=c[4])) for c in layer])
    library_graph_ms = 4 * _cold_ms([(lambda c=c: torch.matmul(c[0], c[5]))
                                     for c in layer])
    rec["fp4_gemm_sweep"] = _split_sweep(layer)
    res["fp4_gemm"] = dict(
        max_abs_err=err_g, ms=sums["ms"], flushed_ms=sums["flushed_ms"],
        graph_ms=graph_ms, plain_ms=sums["plain_ms"],
        library_ms=sums["library_ms"],
        library_flushed_ms=sums["library_flushed_ms"],
        library_graph_ms=library_graph_ms,
        splits=[fused.stream_splits(8, c[1].shape[1], 0, c[1].shape[0] * 8,
                                    c[4].block_m, c[4].block_n, sms)[0]
                for c in layer],
        **bound(sums["nbytes"], sums["flops"]),
        at="nvfp4 m=8, sum of the 4 Llama-3-8B projections at the default "
           "tile and splits; ms L2-warm (flushed_ms: L2 flushed; graph_ms: "
           "a CUDA graph of the four, each finding its weights cold); "
           "library: torch.matmul on the dequantized bf16 weights")
    log(f"[kernels] gemm layer (nvfp4 m=8, 4 projections, splits "
        f"{res['fp4_gemm']['splits']}): kernel {sums['ms']:.4f} ms warm, "
        f"{sums['flushed_ms']:.4f} flushed, {graph_ms:.4f} graph; matmul "
        f"{sums['library_ms']:.4f} warm, {sums['library_flushed_ms']:.4f} "
        f"flushed, {library_graph_ms:.4f} graph; bound "
        f"{res['fp4_gemm']['bound_ms']:.4f} ms")
    del layer
    # --- decode attention ---------------------------------------------------
    B, H, Hkv, d, S = 8, 32, 8, 128, 2048
    q = torch.randn((B, H, d), generator=gen, device=dev).to(torch.bfloat16)
    ck = torch.randn((B, S, Hkv, d), generator=gen, device=dev).to(
        torch.bfloat16)
    cv = torch.randn((B, S, Hkv, d), generator=gen, device=dev).to(
        torch.bfloat16)
    pos = torch.tensor([0, 5, 127, 128, 700, 1023, 1500, 2047],
                       dtype=torch.int32, device=dev)
    nb = S // 128
    got = attention.decode_attention_contiguous(q, ck, cv, pos, nb=nb)
    want = attention.decode_attention_reference(q, ck, cv, pos, nb=nb)
    torch.cuda.synchronize()
    e = _close("decode attention", got, want, 2 ** -7, 2 ** -7)
    t_k = cuda_ms(lambda: attention.decode_attention_contiguous(
        q, ck, cv, pos, nb=nb))
    t_p = cuda_ms(lambda: attention.decode_attention_reference(
        q, ck, cv, pos, nb=nb), iters=5)
    again = attention.decode_attention_contiguous(q, ck, cv, pos, nb=nb)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int16), again.view(torch.int16)):
        raise AssertionError("decode attention: two launches differ")
    t_g = _graph_ms(lambda: attention.decode_attention_contiguous(
        q, ck, cv, pos, nb=nb))
    dmask = _decode_mask(pos, S, S)
    sdpa = _decode_sdpa(q, ck.transpose(1, 2), cv.transpose(1, 2), dmask,
                        "flat cache as a strided (B, Hkv, S, d) view")
    t_l = sdpa["flat cache as a strided (B, Hkv, S, d) view"]["ms"]
    res["decode_attention"] = dict(
        max_abs_err=e, ms=t_k, graph_ms=t_g, plain_ms=t_p, library_ms=t_l,
        library=sdpa, splits=attention.decode_split_plan(B, Hkv, S),
        **bound(*_decode_work(q, pos, Hkv, 2)),
        at="B=8 H=32 Hkv=8 d=128 S=2048 ragged pos, two launches bit for "
           "bit; graph_ms: a CUDA graph of 20 launches; library: "
           "scaled_dot_product_attention(enable_gqa=True) with a boolean "
           "position mask (B, 1, 1, S) over the flat cache's strided view "
           "(library) and over a contiguous copy")
    log(f"[kernels] decode attention err={e:.2e}, repeatable; kernel="
        f"{t_k:.4f} ms graph={t_g:.4f} ms plain={t_p:.4f} ms sdpa "
        + ", ".join(f"{k} {v['ms']:.4f} ms (graph {v['graph_ms']:.4f})"
                    for k, v in sdpa.items())
        + f" bound={res['decode_attention']['bound_ms']:.4f} ms")
    # --- flash prefill ------------------------------------------------------
    T = 256
    pos0 = torch.tensor([0, 256], dtype=torch.int32, device=dev)
    qp = torch.randn((2, T, H, d), generator=gen, device=dev).to(
        torch.bfloat16)
    ns = 4
    got = attention.flash_prefill_attention(qp, ck[:2], cv[:2], pos0, ns=ns)
    want = attention.flash_prefill_reference(qp, ck[:2], cv[:2], pos0, ns=ns)
    torch.cuda.synchronize()
    e = _close("flash prefill", got, want, 2 ** -7, 2 ** -7)
    t_k = cuda_ms(lambda: attention.flash_prefill_attention(
        qp, ck[:2], cv[:2], pos0, ns=ns))
    t_p = cuda_ms(lambda: attention.flash_prefill_reference(
        qp, ck[:2], cv[:2], pos0, ns=ns), iters=5)
    W = ns * 128
    pmask = _prefill_mask(pos0, T, W)
    t_l = cuda_ms(lambda: _sdpa(qp.transpose(1, 2), ck[:2, :W].transpose(1, 2),
                                cv[:2, :W].transpose(1, 2), pmask))
    res["prefill_attention"] = dict(
        max_abs_err=e, ms=t_k, plain_ms=t_p, library_ms=t_l,
        graph_ms=_cold_ms([lambda: attention.flash_prefill_attention(
            qp, ck[:2], cv[:2], pos0, ns=ns)]),
        **bound(*_prefill_work(qp, pos0, Hkv, 2)),
        at="B=2 T=256 pos0=(0,256) H=32 Hkv=8 d=128 S=2048; library: "
           "scaled_dot_product_attention(enable_gqa=True), causal mask")
    log(f"[kernels] flash prefill err={e:.2e} kernel={t_k:.4f} ms "
        f"graph={res['prefill_attention']['graph_ms']:.4f} ms "
        f"plain={t_p:.4f} ms sdpa={t_l:.4f} ms "
        f"bound={res['prefill_attention']['bound_ms']:.4f} ms")
    _prefill_serving(
        res, rows, gen, "prefill_attention", "bf16 flat",
        lambda q_, p_, n_: attention.flash_prefill_attention(
            q_, ck[:1], cv[:1], p_, ns=n_),
        lambda q_, p_, n_: attention.flash_prefill_reference(
            q_, ck[:1], cv[:1], p_, ns=n_),
        lambda q_, w_, m_: _sdpa(q_.transpose(1, 2),
                                 ck[:1, :w_].transpose(1, 2),
                                 cv[:1, :w_].transpose(1, 2), m_),
        2, 128)
    # --- kv append ----------------------------------------------------------
    kn = torch.randn((B, Hkv, d), generator=gen, device=dev).to(
        torch.bfloat16)
    vn = torch.randn((B, Hkv, d), generator=gen, device=dev).to(
        torch.bfloat16)
    mask = torch.tensor([1, 0, 1, 1, 0, 1, 0, 1], dtype=torch.int32,
                        device=dev)
    ck1, cv1 = ck.clone(), cv.clone()
    ck2, cv2 = ck.clone(), cv.clone()
    attention.kv_append(ck1, cv1, kn, vn, pos, mask)
    attention.kv_append_reference(ck2, cv2, kn, vn, pos, mask)
    torch.cuda.synchronize()
    if not (torch.equal(ck1.view(torch.int16), ck2.view(torch.int16))
            and torch.equal(cv1.view(torch.int16), cv2.view(torch.int16))):
        raise AssertionError("kv_append: cache bytes differ from the twin")
    t_k = cuda_ms(lambda: attention.kv_append(ck1, cv1, kn, vn, pos, mask))
    t_g = _graph_ms(lambda: attention.kv_append(ck1, cv1, kn, vn, pos, mask))
    t_p = cuda_ms(lambda: attention.kv_append_reference(ck2, cv2, kn, vn,
                                                        pos, mask))
    sel = mask.bool().nonzero().squeeze(1)
    idx, kv_rows = (sel, pos[sel].long()), (kn[sel], vn[sel])
    t_l = cuda_ms(lambda: (ck2.index_put_(idx, kv_rows[0]),
                           cv2.index_put_(idx, kv_rows[1])))
    res["kv_append"] = dict(
        max_abs_err=0.0, ms=t_k, graph_ms=t_g, plain_ms=t_p, library_ms=t_l,
        **bound(*_append_work(int(mask.bool().sum()), Hkv, d, 2, 8 * B)),
        at="B=8 S=2048 Hkv=8 d=128, mixed mask, bit-exact; graph_ms: a CUDA "
           "graph of 20 launches; library: index_put_ on K and V with the "
           "masked rows' indices")
    log(f"[kernels] kv_append bit-exact kernel={t_k:.4f} ms graph={t_g:.4f} "
        f"ms plain={t_p:.4f} ms index_put_={t_l:.4f} ms")
    _headed_kernels(rec, res, rows, gen, q, qp, pos, pos0, kn, vn, mask)
    del ck, cv, ck1, cv1, ck2, cv2
    _append_kernels(rec, res, rows, gen, pos, kn, vn, mask)
    _grouped_kernels(res, rows, gen)
    _grouped_routed(res)
    _w4a8_kernels(rec, res, rows, gen)
    _dequant_kernels(res, rows, gen)
    _hybrid_kernels(res, rows, gen)
    _spec_verify_kernels(res, rows, gen)
    _spec_gemm_rows(res, rows, gen)
    rec["kernel_rows"] = rows
    rec["kernels"] = res


# the speculative tick's verify: B = 4 rows at mixed positions (those of
# phase decode_attn_layer's engine shape), the last row masked (an idle
# slot), chunks of T = g + 1 for the draft depths 3, 5, 7 and 11 over a
# 512 window
SPEC_POS0 = (274, 316, 177, 108)
SPEC_TS = (4, 6, 8, 12)


def _spec_verify_kernels(res, rows, gen):
    """The verify's KV write and flash prefill at SPEC_TS, flat bf16 and
    headed fp8 (B = 4, H = 32, Hkv = 8, d = 128, S = 2048, window 512,
    pos0 SPEC_POS0, row 3 masked): the chunk's K/V appended with the mask
    (kv_append / kv_append_headed, bit for bit the twin's cache bytes),
    then flash prefill over the written cache against its twin at 2^-7.
    Each is timed beside its twin (and, for bf16 prefill, one SDPA call
    over the window) with its bound; kept as rows and as each kernel's
    "spec_verify" entry."""
    dev = gen.device
    B, H, Hkv, d, S, W = 4, 32, 8, 128, 2048, 512
    pos0 = torch.tensor(SPEC_POS0, dtype=torch.int32, device=dev)
    mask = torch.tensor([1, 1, 1, 0], dtype=torch.bool, device=dev)
    ns = W // 128
    for tag, dtype, headed in (("bf16 flat", torch.bfloat16, False),
                               ("fp8 headed", FP8, True)):
        shape = (B, Hkv, S, d) if headed else (B, S, Hkv, d)
        ck = torch.randn(shape, generator=gen, device=dev).to(dtype)
        cv = torch.randn(shape, generator=gen, device=dev).to(dtype)
        elt = ck.element_size()
        append = attention.kv_append_headed if headed else attention.kv_append
        append_twin = (attention.kv_append_headed_reference if headed
                       else attention.kv_append_reference)
        pre = (attention.flash_prefill_headed if headed
               else attention.flash_prefill_attention)
        pre_twin = (attention.flash_prefill_headed_reference if headed
                    else attention.flash_prefill_reference)
        for T in SPEC_TS:
            q = torch.randn((B, T, H, d), generator=gen, device=dev).to(
                torch.bfloat16)
            kn = torch.randn((B, T, Hkv, d), generator=gen, device=dev).to(
                torch.bfloat16)
            vn = torch.randn((B, T, Hkv, d), generator=gen, device=dev).to(
                torch.bfloat16)
            tpos = pos0[:, None] + torch.arange(T, dtype=torch.int32,
                                                device=dev)[None]
            c1 = (ck.clone(), cv.clone())
            c2 = (ck.clone(), cv.clone())
            append(*c1, kn, vn, tpos, mask)
            append_twin(*c2, kn, vn, tpos, mask)
            torch.cuda.synchronize()
            at = (f"{tag} spec verify B={B} T={T} pos0={SPEC_POS0} row 3 "
                  f"masked window={W}")
            if not all(torch.equal(attention._bits(a), attention._bits(b))
                       for a, b in zip(c1, c2)):
                raise AssertionError(f"{append.__name__} {at}: cache bytes "
                                     "differ from the twin")
            got = pre(q, *c1, pos0, ns=ns)
            want = pre_twin(q, *c1, pos0, ns=ns)
            torch.cuda.synchronize()
            pname = ("prefill_attention_headed" if headed
                     else "prefill_attention")
            e = _close(f"{pname} {at}", got, want, 2 ** -7, 2 ** -7)
            res[pname]["max_abs_err"] = max(res[pname]["max_abs_err"], e)
            lib = None
            if not headed:
                pm = _prefill_mask(pos0, T, W)
                lib = cuda_ms(lambda: _sdpa(
                    q.transpose(1, 2), c1[0][:, :W].transpose(1, 2),
                    c1[1][:, :W].transpose(1, 2), pm))
            prow = dict(kernel=pname, variant=at, max_abs_err=e,
                        ms=cuda_ms(lambda: pre(q, *c1, pos0, ns=ns)),
                        graph_ms=_cold_ms([lambda: pre(q, *c1, pos0,
                                                       ns=ns)]),
                        plain_ms=cuda_ms(lambda: pre_twin(q, *c1, pos0,
                                                          ns=ns), iters=5),
                        library_ms=lib,
                        **bound(*_prefill_work(q, pos0, Hkv, elt)))
            aname = "kv_append_headed" if headed else "kv_append"
            arow = dict(kernel=aname, variant=at, max_abs_err=0.0,
                        ms=cuda_ms(lambda: append(*c1, kn, vn, tpos, mask)),
                        graph_ms=_cold_ms([lambda: append(*c1, kn, vn, tpos,
                                                          mask)]),
                        plain_ms=cuda_ms(lambda: append_twin(
                            *c2, kn, vn, tpos, mask), iters=5),
                        library_ms=None,
                        **bound(*_append_work(3 * T, Hkv, d, elt,
                                              _nbytes(tpos, mask))))
            for row in (prow, arow):
                rows.append(row)
                res[row["kernel"]].setdefault("spec_verify", {})[
                    f"{tag} T={T}"] = {k: row[k] for k in (
                        "ms", "graph_ms", "plain_ms", "library_ms",
                        "bound_ms", "bound_by")}
            log(f"[kernels] spec verify {at}: {aname} bit-exact "
                f"{arow['ms']:.4f} ms (graph {arow['graph_ms']:.4f}, plain "
                f"{arow['plain_ms']:.4f}, bound {arow['bound_ms']:.4f}); "
                f"{pname} err={e:.2e} {prow['ms']:.4f} ms (graph "
                f"{prow['graph_ms']:.4f}, plain {prow['plain_ms']:.4f}, "
                f"sdpa {lib}, bound {prow['bound_ms']:.4f})")
            del c1, c2
        del ck, cv


def _spec_gemm_rows(res, rows, gen):
    """fp4_gemm at the verify's m = B * (g + 1) = 16, 24, 32 and 48 (B = 4,
    g = 3, 5, 7, 11) over the four Llama-3-8B projections, nvfp4, default
    tile and splits (48 is the first of them on the 64-row wgmma tiles):
    two launches bit for bit, against the twin at the GEMM tolerance,
    timed L2-warm beside the twin and torch.matmul on the dequantized
    weights, with the bound; kept as rows and, summed over the four, as
    fp4_gemm's "spec_m" entry."""
    dev = gen.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for k, n in LLAMA8B_KN:
        w = torch.randn((n, k), generator=gen, device=dev) / math.sqrt(k)
        qw, sc, gs = qref.quantize_nvfp4(w)
        words = layout.repack_fp4_weights(qw, n, k)
        st = layout.process_fp4_scales(sc, n, k, group_size=16)
        gs = gs.reshape(1)
        deq = (layout.dequant_from_tpu_layout(words, st, n, k)
               * gs).to(torch.bfloat16)
        del w, qw, sc
        for m in (16, 24, 32, 48):
            a = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            sid = solution_mod.choose_default_solution(m, n, k,
                                                       ElementB.NVFP4)
            splits = fused.stream_splits(m, n, 0, words.shape[0] * 8,
                                         sid.block_m, sid.block_n, sms)[0]
            got = fused.fused_mul(a, words, st, gs, sid=sid)
            again = fused.fused_mul(a, words, st, gs, sid=sid)
            want = fused.fused_mul_reference(a, words, st, gs, sid=sid)
            torch.cuda.synchronize()
            what = f"gemm spec verify m={m} k={k} n={n}"
            if not torch.equal(got.view(torch.int16),
                               again.view(torch.int16)):
                raise AssertionError(f"{what}: two launches differ")
            e = _close(what, got, want, 2 ** -7,
                       2 ** -8 * want.float().abs().max())
            res["fp4_gemm"]["max_abs_err"] = max(
                res["fp4_gemm"]["max_abs_err"], e)
            row = dict(kernel="fp4_gemm", fmt="nvfp4", m=m, k=k, n=n,
                       tile=[sid.block_m, sid.block_n], splits=splits,
                       max_abs_err=e,
                       ms=cuda_ms(lambda: fused.fused_mul(a, words, st, gs,
                                                          sid=sid)),
                       plain_ms=cuda_ms(lambda: fused.fused_mul_reference(
                           a, words, st, gs, sid=sid), iters=5),
                       library_ms=cuda_ms(lambda: torch.matmul(a, deq)),
                       variant="spec verify",
                       **bound(_nbytes(words, st, gs, a, got), 2 * m * n * k))
            rows.append(row)
            acc = out.setdefault(f"m={m}", dict(ms=0.0, plain_ms=0.0,
                                                library_ms=0.0, bound_ms=0.0,
                                                tiles=[]))
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                acc[key] += row[key]
            acc["tiles"].append(f"{sid.block_m}x{sid.block_n}/{splits}")
            log(f"[kernels] {what} tile={sid.block_m}x{sid.block_n} "
                f"splits={splits} err={e:.2e}, repeatable; kernel="
                f"{row['ms']:.4f} ms plain={row['plain_ms']:.4f} ms matmul="
                f"{row['library_ms']:.4f} ms bound={row['bound_ms']:.4f} ms")
        del deq
    res["fp4_gemm"]["spec_m"] = out
    log("[kernels] gemm spec verify layers (4 projections): " + ", ".join(
        f"{m} {v['ms']:.4f} ms (matmul {v['library_ms']:.4f}, bound "
        f"{v['bound_ms']:.4f})" for m, v in out.items()))


def _headed_kernels(rec, res, rows, gen, q, qp, pos, pos0, kn, vn, mask):
    """The headed-layout kernels at the shapes of phase 3's flat ones
    (B=8 decode over a 2048-position window, B=2 T=256 prefill), page
    sizes 16 and 256, bf16 and fp8 K/V. Each kernel's JSON row keeps the
    largest error of its variants and the times of the variant the serve_kv
    phase runs (fp8; page size 16 where the kernel pages). The library
    yardsticks: scaled_dot_product_attention and index_put_ for bf16
    contiguous caches; none for fp8 (neither takes fp8 K/V without a cast
    first) or pages (a gather first)."""
    dev = q.device
    B, H, d = q.shape
    Hkv, S = 8, 2048
    T = qp.shape[1]

    def kv(dtype, *shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def check(name, variant, kernel, twin, served, work, library=None,
              exact=False, label=None):
        got, want = kernel(), twin()
        torch.cuda.synchronize()
        if exact:
            if not all(torch.equal(attention._bits(g), attention._bits(w))
                       for g, w in zip(got, want)):
                raise AssertionError(f"{name} {variant}: cache bytes differ "
                                     "from the twin")
            e = 0.0
        else:
            e = _close(f"{name} {variant}", got, want, 2 ** -7, 2 ** -7)
        if "decode" in name and not torch.equal(
                got.view(torch.int16), kernel().view(torch.int16)):
            raise AssertionError(f"{name} {variant}: two launches differ")
        t_k = cuda_ms(kernel)
        t_p = cuda_ms(twin, iters=5)
        t_l = cuda_ms(library) if library else None
        row = dict(kernel=name, variant=variant, max_abs_err=e, ms=t_k,
                   plain_ms=t_p, library_ms=t_l, **bound(*work))
        if label:
            row["library"] = label
        if "prefill" in name or "append" in name or "decode" in name:
            row["graph_ms"] = _cold_ms([kernel])
        rows.append(row)
        graph = (f" graph={row['graph_ms']:.4f} ms" if "graph_ms" in row
                 else "")
        log(f"[kernels] {name} {variant} err={e:.2e} kernel={t_k:.4f} ms"
            f"{graph} plain={t_p:.4f} ms library={t_l} ms "
            f"bound={row['bound_ms']:.4f} ms")
        r = res.setdefault(name, dict(max_abs_err=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], e)
        if served:
            r.update(ms=t_k, plain_ms=t_p, library_ms=t_l,
                     bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                     at=variant)
            if "graph_ms" in row:
                r["graph_ms"] = row["graph_ms"]

    sel = mask.bool().nonzero().squeeze(1)
    for dtype in (torch.bfloat16, FP8):
        tag = "bf16" if dtype == torch.bfloat16 else "fp8"
        elt = 2 if dtype == torch.bfloat16 else 1
        for ps in (16, 256):
            nb = S // ps                   # pages per sequence
            P = B * nb + 1
            kp, vp = kv(dtype, P, Hkv, ps, d), kv(dtype, P, Hkv, ps, d)
            bt = torch.randperm(P - 1, generator=gen, device=dev)[:B * nb]
            bt = bt.reshape(B, nb).to(torch.int32)
            at = (f"{tag} ps={ps} B={B} H={H} Hkv={Hkv} d={d} "
                  f"window={S} ragged pos")
            check("paged_decode_attention", at,
                  lambda: attention.paged_decode_attention(
                      q, kp, vp, bt, pos, nb=nb, page_size=ps),
                  lambda: attention.paged_decode_reference(
                      q, kp, vp, bt, pos, nb=nb, page_size=ps),
                  dtype == FP8 and ps == 16,
                  _decode_work(q, pos, Hkv, elt, page_size=ps))
            ns = 512 // ps
            at = f"{tag} ps={ps} B=2 T=256 pos0=(0,256) H={H} Hkv={Hkv}"
            check("paged_prefill_attention", at,
                  lambda: attention.flash_prefill_paged(
                      qp, kp, vp, bt[:2], pos0, ns=ns),
                  lambda: attention.flash_prefill_paged_reference(
                      qp, kp, vp, bt[:2], pos0, ns=ns),
                  dtype == FP8 and ps == 16,
                  _prefill_work(qp, pos0, Hkv, elt, page_size=ps))
            if dtype == FP8 and ps == 16:
                # library: SDPA over the bf16 upcast of the gathered pages
                # (gather and cast not timed)
                k16, v16 = (attention._gather_pages(x, bt[:1], nb).to(
                    torch.bfloat16).transpose(1, 2).contiguous()
                    for x in (kp, vp))
                _prefill_serving(
                    res, rows, gen, "paged_prefill_attention",
                    f"fp8 ps={ps}",
                    lambda q_, p_, n_: attention.flash_prefill_paged(
                        q_, kp, vp, bt[:1], p_, ns=n_),
                    lambda q_, p_, n_: attention.flash_prefill_paged_reference(
                        q_, kp, vp, bt[:1], p_, ns=n_),
                    lambda q_, w_, m_: _sdpa(q_.transpose(1, 2),
                                             k16[:, :, :w_], v16[:, :, :w_],
                                             m_),
                    elt, ps, page_size=ps)
                del k16, v16
            del kp, vp
        ck, cv = kv(dtype, B, Hkv, S, d), kv(dtype, B, Hkv, S, d)
        bf16 = dtype == torch.bfloat16
        dmask, pmask = _decode_mask(pos, S, S), _prefill_mask(pos0, T, 512)
        check("decode_attention_headed",
              f"{tag} B={B} H={H} Hkv={Hkv} d={d} S={S} ragged pos",
              lambda: attention.decode_attention_contiguous_headed(
                  q, ck, cv, pos, nb=S // 128, page_size=128),
              lambda: attention.decode_attention_headed_reference(
                  q, ck, cv, pos, nb=S // 128, page_size=128),
              dtype == FP8, _decode_work(q, pos, Hkv, elt),
              library=bf16 and (lambda: _sdpa(q[:, :, None], ck, cv, dmask)),
              label=bf16 and "scaled_dot_product_attention(enable_gqa=True) "
              "over the contiguous (B, Hkv, S, d) bf16 cache, boolean "
              "position mask (B, 1, 1, S)")
        check("prefill_attention_headed",
              f"{tag} B=2 T=256 pos0=(0,256) H={H} Hkv={Hkv} S={S}",
              lambda: attention.flash_prefill_attention(
                  qp, ck[:2], cv[:2], pos0, ns=4, headed=True),
              lambda: attention.flash_prefill_headed_reference(
                  qp, ck[:2], cv[:2], pos0, ns=4),
              dtype == FP8, _prefill_work(qp, pos0, Hkv, elt),
              library=bf16 and (lambda: _sdpa(
                  qp.transpose(1, 2), ck[:2, :, :512], cv[:2, :, :512],
                  pmask)))
        if dtype == FP8:
            # library: SDPA over the bf16 upcast (cast not timed)
            k16, v16 = ck[:1].to(torch.bfloat16), cv[:1].to(torch.bfloat16)
            _prefill_serving(
                res, rows, gen, "prefill_attention_headed", "fp8 headed",
                lambda q_, p_, n_: attention.flash_prefill_attention(
                    q_, ck[:1], cv[:1], p_, ns=n_, headed=True),
                lambda q_, p_, n_: attention.flash_prefill_headed_reference(
                    q_, ck[:1], cv[:1], p_, ns=n_),
                lambda q_, w_, m_: _sdpa(q_.transpose(1, 2), k16[:, :, :w_],
                                         v16[:, :, :w_], m_),
                elt, 128)
            del k16, v16
        ck1, cv1, ck2, cv2 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
        idx = (sel[:, None], torch.arange(Hkv, device=dev)[None],
               pos[sel].long()[:, None])
        check("kv_append_headed",
              f"{tag} B={B} Hkv={Hkv} S={S} d={d}, mixed mask, bit-exact",
              lambda: attention.kv_append(ck1, cv1, kn, vn, pos, mask,
                                          headed=True),
              lambda: attention.kv_append_headed_reference(
                  ck2, cv2, kn, vn, pos, mask),
              dtype == FP8,
              _append_work(int(mask.bool().sum()), Hkv, d, elt, 8 * B),
              library=bf16 and (lambda: (ck2.index_put_(idx, kn[sel]),
                                         cv2.index_put_(idx, vn[sel]))),
              exact=True)
        del ck, cv, ck1, cv1, ck2, cv2


def _paged_glue(pages_kv, bt_rows, new_k, new_v, pos, page_size,
                write_mask=None):
    """The paged KV write as torch ops, kept as the paged append's yardstick:
    models/paged.py _write_kv before the append kernel (gather, two where,
    the row arithmetic, two casts and two index_put_, about 16 launches)."""
    k_pages, v_pages = pages_kv
    B, T = pos.shape
    nh = k_pages.shape[1]
    p = pos.long()
    page_idx = torch.gather(bt_rows.long(), 1, p // page_size)
    if write_mask is not None:
        keep = write_mask.bool()[:, None]
        page_idx = torch.where(keep, page_idx, k_pages.shape[0] - 1)
        p = torch.where(keep, p, 0)
    row_idx = ((page_idx.reshape(-1, 1) * nh
                + torch.arange(nh, device=p.device)) * page_size
               + (p % page_size).reshape(-1, 1))
    for pages, new in ((k_pages, new_k), (v_pages, new_v)):
        P, h, ps, d = pages.shape
        flat = attention._bits(pages).view(P * h * ps, d)
        flat[row_idx] = attention._bits(attention.quantize_kv(
            new.reshape(B * T, h, d), pages.dtype))


def _fused_kv(gen, B, T, hkv=8, d=128, nq=32):
    """New K and V (B, T, hkv, d) as the Llama block makes them: strided
    views of one fused qkv tensor (returned too, to refill in place)."""
    qkv = torch.randn((B, T, (nq + 2 * hkv) * d), generator=gen,
                      device="cuda").to(torch.bfloat16)
    return (qkv, qkv[..., nq * d:(nq + hkv) * d].reshape(B, T, hkv, d),
            qkv[..., (nq + hkv) * d:].reshape(B, T, hkv, d))


def _append_layouts(gen, B, S=2048, ps=16, hkv=8, d=128):
    """The append body's five served layouts as {name: (cache pair, write
    (cache, k, v, pos, mask), its twin)}: flat bf16, headed bf16 and fp8,
    paged bf16 and fp8 at page size 16 (each row's S / ps pages permuted
    over a pool with a scratch page)."""
    out = {}
    for name, shape, dtype in (
            ("flat bf16", (B, S, hkv, d), torch.bfloat16),
            ("headed bf16", (B, hkv, S, d), torch.bfloat16),
            ("headed fp8", (B, hkv, S, d), FP8),
            ("paged bf16", (B * S // ps + 1, hkv, ps, d), torch.bfloat16),
            ("paged fp8", (B * S // ps + 1, hkv, ps, d), FP8)):
        cache = tuple(torch.randn(shape, generator=gen, device="cuda").to(
            dtype) for _ in range(2))
        if name.startswith("paged"):
            bt = torch.randperm(shape[0] - 1, generator=gen, device="cuda")
            bt = bt.reshape(B, S // ps).to(torch.int32)
            out[name] = (
                cache,
                lambda c, k, v, p, m, bt=bt: attention.kv_append_paged(
                    *c, bt, k, v, p, ps, m),
                lambda c, k, v, p, m, bt=bt:
                    attention.kv_append_paged_reference(*c, bt, k, v, p, ps,
                                                        m),
                bt)
        else:
            headed = name.startswith("headed")
            twin = (attention.kv_append_headed_reference if headed
                    else attention.kv_append_reference)
            out[name] = (
                cache,
                lambda c, k, v, p, m, h=headed: attention.kv_append(
                    *c, k, v, p, m, headed=h),
                lambda c, k, v, p, m, t=twin: t(*c, k, v, p, m), None)
    return out


def _append_kernels(rec, res, rows, gen, pos, kn, vn, mask):
    """The append body beyond the flat and headed decode rows: the paged
    write at page size 16 (bf16 and fp8, B = 8, the kernels phase's
    positions and mask) bit for bit its twin, timed warm, as a CUDA graph
    of 24 launches, beside its twin and the torch glue it replaced (as a
    graph); every layout's 256-token chunk (B = 2, one row masked, K and V
    strided views of the fused qkv tensor) bit for bit its twin, timed as a
    graph; the fp8 rounding of all 65,536 bf16 patterns against torch's
    cast; and each entry captured in a CUDA graph, replayed three times
    after new positions, values and mask, against eager launches."""
    B, Hkv, d = kn.shape
    ps = 16
    lay = _append_layouts(gen, B)
    new = (kn[:, None], vn[:, None], pos[:, None])
    checks = {}
    for tag in ("bf16", "fp8"):
        cache, write, twin, bt = lay[f"paged {tag}"]
        got, want = [c.clone() for c in cache], [c.clone() for c in cache]
        write(got, *new, mask)
        twin(want, *new, mask)
        torch.cuda.synchronize()
        # three masked rows land on the scratch page (the last) at offset
        # 0, in no set order: it is left out
        if not all(torch.equal(attention._bits(g[:-1]),
                               attention._bits(w[:-1]))
                   for g, w in zip(got, want)):
            raise AssertionError(f"kv_append_paged {tag}: pool bytes differ "
                                 "from the twin")
        t_k = cuda_ms(lambda: write(got, *new, mask))
        t_g = _graph_ms(lambda: write(got, *new, mask), reps=24)
        t_p = cuda_ms(lambda: twin(want, *new, mask), iters=5)
        t_l = _graph_ms(lambda: _paged_glue(want, bt, *new, ps, mask),
                        reps=24)
        kept = int(mask.bool().sum())
        elt = 1 if tag == "fp8" else 2
        # every row writes one token (a masked one to the scratch page);
        # the kept rows read their block-table entry
        row = dict(kernel="kv_append_paged", variant=f"{tag} ps={ps} B={B}",
                   max_abs_err=0.0, ms=t_k, graph_ms=t_g, plain_ms=t_p,
                   library_ms=t_l,
                   library="graph of the torch glue the kernel replaced "
                           "(models/paged.py _write_kv before it: gather, "
                           "where, row arithmetic, casts, index_put_)",
                   **bound(*_append_work(B, Hkv, d, elt, 8 * B + 4 * kept)))
        rows.append(row)
        log(f"[kernels] kv_append_paged {row['variant']} bit-exact kernel="
            f"{t_k:.4f} ms graph={t_g:.4f} ms plain={t_p:.4f} ms glue graph="
            f"{t_l:.4f} ms bound={row['bound_ms']:.6f} ms")
        if tag == "fp8":
            res["kv_append_paged"] = dict(row, at=row["variant"] + ", mixed "
                                          "mask, positions to 2047")
    # 256-token chunks, every layout
    qkv, k, v = _fused_kv(gen, 2, 256)
    cpos = torch.tensor([0, 1536], device="cuda")[:, None] + torch.arange(
        256, device="cuda")
    cmask = torch.tensor([True, False], device="cuda")
    lay2 = _append_layouts(gen, 2)
    for name, (cache, write, twin, _) in lay2.items():
        got, want = [c.clone() for c in cache], [c.clone() for c in cache]
        write(got, k, v, cpos, cmask)
        twin(want, k, v, cpos, cmask)
        torch.cuda.synchronize()
        if not all(torch.equal(attention._bits(g), attention._bits(w))
                   for g, w in zip(got, want)):
            raise AssertionError(f"append {name} T=256: cache bytes differ "
                                 "from the twin")
        checks[f"{name} T=256"] = _graph_ms(
            lambda: write(got, k, v, cpos, cmask))
        log(f"[kernels] append {name} B=2 T=256 (K, V fused views, one row "
            f"masked) bit-exact, graph {checks[f'{name} T=256']:.4f} ms")
    # the fp8 rounding of every bf16 pattern
    x = torch.arange(-2 ** 15, 2 ** 15, device="cuda").to(torch.int16).view(
        torch.bfloat16).reshape(4, 16, 8, 128)
    ck8, cv8 = (torch.zeros((4, 8, 16, 128), dtype=FP8, device="cuda")
                for _ in range(2))
    attention.kv_append(ck8, cv8, x, x.flip(0),
                        torch.arange(16, device="cuda").expand(4, 16),
                        headed=True)
    for c, n in ((ck8, x), (cv8, x.flip(0))):
        if not torch.equal(attention._bits(c), attention._bits(
                n.to(FP8).transpose(1, 2))):
            raise AssertionError("append: fp8 rounding differs from torch's "
                                 "cast on the 65,536 bf16 patterns")
    log("[kernels] append fp8 rounding: all 65,536 bf16 patterns equal "
        f".to(float8_e4m3fn) (fp8_saturates={attention.fp8_saturates()})")
    # CUDA graph replays against eager launches
    qkv, k, v = _fused_kv(gen, 2, 7)
    for name in ("flat bf16", "headed fp8", "paged fp8"):
        cache, write, _, _ = lay2[name]
        rpos = torch.tensor([3, 700], device="cuda")[:, None] + torch.arange(
            7, device="cuda")
        rmask = torch.tensor([True, True], device="cuda")
        graphed, eager = [c.clone() for c in cache], [c.clone() for c in cache]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            write([c.clone() for c in cache], k, v, rpos, rmask)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            write(graphed, k, v, rpos, rmask)
        for step in range(1, 4):
            rpos.add_(97 * step)
            qkv.copy_(torch.randn(qkv.shape, generator=gen,
                                  device="cuda").to(torch.bfloat16))
            rmask[0] = step != 2
            graph.replay()
            write(eager, k, v, rpos, rmask)
            torch.cuda.synchronize()
            if not all(torch.equal(attention._bits(g), attention._bits(e))
                       for g, e in zip(graphed, eager)):
                raise AssertionError(f"append {name}: graph replay {step} "
                                     "differs from an eager launch")
        del graph
        log(f"[kernels] append {name} T=7: 3 CUDA graph replays with new "
            "positions, values and mask equal eager launches")
    rec["append_chunks_graph_ms"] = checks


def _grouped_kernels(res, rows, gen):
    """The grouped expert GEMM at Mixtral-8x7B's expert shapes, E=8: w_gate
    and w_up (k, n) = (4096, 14336), w_down (14336, 4096), cap 8 (a 4-slot
    decode step) and 128 (a 64-token chunk), mxfp4 (the served format) and
    nvfp4, at grouped_mul's default splits. Each is held against its plain
    twin (GEMM tolerance) and, bit for bit, against fused_mul on each
    expert's slice at the same tile and splits; the library yardstick is
    torch.bmm on the dequantized bf16 experts.
    The JSON row is one MoE layer's decode GEMMs, mxfp4 cap 8: w_gate +
    w_up + w_down; the same sum at cap 128 (the 64-row wgmma tiles) is
    logged and kept as the row's "prefill"."""
    dev = torch.device("cuda")
    E = MIXTRAL_8X7B.num_experts
    layer = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0, flops=0)
    prefill = dict(layer)
    err = 0.0
    for fmt in ("mxfp4", "nvfp4"):
        eb = ElementB.MXFP4 if fmt == "mxfp4" else ElementB.NVFP4
        for k, n in MIXTRAL_EXPERT_KN:
            w = torch.randn((E, k, n), generator=gen, device=dev,
                            dtype=torch.bfloat16) / math.sqrt(k)
            ex = moe.quantize_moe_linear(w, fmt)
            del w
            words, st, gs = ex["words"], ex["scales"], ex["gs"]
            deq = torch.stack([
                (layout.dequant_from_tpu_layout(words[e], st[e], n, k)
                 * gs[e]).to(torch.bfloat16) for e in range(E)])
            for cap in (8, 128):
                xs = torch.randn((E, cap, k), generator=gen,
                                 device=dev).to(torch.bfloat16)
                sid = gemm.resolve_grouped_solution(cap, n, k, eb)
                splits = grouped.grouped_splits(
                    E, cap, n, words.shape[1] * 8, sid.block_m, sid.block_n,
                    fused._num_sms(dev.index or 0))
                got = grouped.grouped_mul(xs, words, st, gs, sid=sid)
                want = grouped.grouped_mul_reference(xs, words, st, gs,
                                                     sid=sid)
                torch.cuda.synchronize()
                what = f"grouped {fmt} E={E} cap={cap} k={k} n={n}"
                e_max = _close(what, got, want, 2 ** -7,
                               2 ** -8 * want.float().abs().max())
                for e in range(E):
                    one = fused.fused_mul(xs[e], words[e], st[e],
                                          gs[e:e + 1], sid=sid, splits=splits)
                    if not torch.equal(one.view(torch.int16),
                                       got[e].view(torch.int16)):
                        raise AssertionError(f"{what}: expert {e} differs "
                                             "from fused_mul bit for bit")
                t_k = cuda_ms(lambda: grouped.grouped_mul(xs, words, st, gs,
                                                          sid=sid))
                t_p = cuda_ms(lambda: grouped.grouped_mul_reference(
                    xs, words, st, gs, sid=sid), iters=2, warmup=1)
                t_l = cuda_ms(lambda: torch.bmm(xs, deq))
                nbytes = _nbytes(words, st, gs, xs, got)
                flops = 2 * E * cap * k * n
                row = dict(kernel="grouped_fp4_gemm", fmt=fmt, E=E, cap=cap,
                           k=k, n=n, tile=[sid.block_m, sid.block_n],
                           splits=splits,
                           max_abs_err=e_max, ms=t_k, plain_ms=t_p,
                           library_ms=t_l, **bound(nbytes, flops))
                rows.append(row)
                log(f"[kernels] {what} tile={sid.block_m}x{sid.block_n} "
                    f"splits={splits} err={e_max:.2e} bit-equal to fused_mul; "
                    f"kernel={t_k:.4f} ms plain={t_p:.4f} ms "
                    f"bmm={t_l:.4f} ms bound={row['bound_ms']:.4f} ms "
                    f"({row['bound_by']})")
                err = max(err, e_max)
                if fmt == "mxfp4":
                    times = 2 if (k, n) == MIXTRAL_EXPERT_KN[0] else 1
                    into = layer if cap == 8 else prefill
                    for key, v in (("ms", t_k), ("plain_ms", t_p),
                                   ("library_ms", t_l), ("nbytes", nbytes),
                                   ("flops", flops)):
                        into[key] += times * v
                del xs, got, want
            del ex, words, st, gs, deq
    res["grouped_fp4_gemm"] = dict(
        max_abs_err=err, ms=layer["ms"], plain_ms=layer["plain_ms"],
        library_ms=layer["library_ms"],
        **bound(layer["nbytes"], layer["flops"]),
        at="mxfp4 E=8 cap=8, one Mixtral-8x7B layer's w_gate + w_up + "
           "w_down; library: torch.bmm on the dequantized bf16 experts",
        prefill=_layer_row(prefill, "mxfp4 E=8 cap=128, the same three"))
    log(f"[kernels] grouped layer mxfp4 cap=128 (w_gate + w_up + w_down): "
        f"kernel {prefill['ms']:.4f} ms, bmm {prefill['library_ms']:.4f} ms, "
        f"bound {res['grouped_fp4_gemm']['prefill']['bound_ms']:.4f} ms "
        f"({res['grouped_fp4_gemm']['prefill']['bound_by']})")


def _layer_row(acc, at):
    """A summed row (ms, plain_ms, library_ms, nbytes, flops) with its
    bound."""
    return dict(ms=acc["ms"], plain_ms=acc["plain_ms"],
                library_ms=acc["library_ms"],
                **bound(acc["nbytes"], acc["flops"]), at=at)


def _mixtral_layer(gen):
    """One Mixtral-8x7B MoE layer as a 4-slot decode step feeds it: the
    three expert projections (w_gate, w_up, w_down; E = 8, mxfp4, each its
    own weights) quantized on the card, and its cap-8 buckets filled two
    ways: "full", every row (the `kernels` row's case), and "routed", the
    rows that top-2 routing of 4 seeded tokens through a random router
    fills, each bucket from row 0 up to its count, zero past it. Returns
    (projections [(words, scales, gs)], {case: (x (E, cap, H), h (E, cap,
    F), rows or None)}). Calls only moe.quantize_moe_linear, moe.route,
    moe.capacity and moe.MoEConfig, which older trees have too."""
    cfg = MIXTRAL_8X7B
    E, H, F = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
    projs = []
    for k, n in ((H, F), (H, F), (F, H)):
        w = torch.randn((E, k, n), generator=gen, device="cuda",
                        dtype=torch.bfloat16) / math.sqrt(k)
        ex = moe.quantize_moe_linear(w, "mxfp4")
        del w
        projs.append((ex["words"], ex["scales"], ex["gs"]))
    T = 4
    cap = moe.capacity(T, moe.MoEConfig(E, cfg.top_k))
    tok = torch.randn((T, H), generator=gen, device="cuda").to(torch.bfloat16)
    router = torch.randn((H, E), generator=gen, device="cuda").to(
        torch.bfloat16)
    _, idx = moe.route(tok, router, cfg.top_k)
    rows = torch.bincount(idx.reshape(-1), minlength=E).clamp_max(cap).to(
        torch.int32)
    x = torch.randn((E, cap, H), generator=gen, device="cuda").to(
        torch.bfloat16)
    h = torch.randn((E, cap, F), generator=gen, device="cuda").to(
        torch.bfloat16)
    live = (torch.arange(cap, device="cuda")[None] < rows[:, None])[..., None]
    return projs, dict(full=(x, h, None),
                       routed=(x * live, h * live, rows))


def _grouped_layer(check=False):
    """_mixtral_layer's three grouped calls through grouped_mul's defaults:
    for each case the sum of their warm times (cuda_ms), the device time of
    a CUDA graph of the three (3 x _cold_ms; 880.8 MB of weights, each call
    finds its own cold) and the host time of one call. The routed case
    runs only where the tree's grouped_mul takes `rows`. With `check`, the
    routed calls are held bit for bit against the same calls without rows,
    the experts no token chose give +0, and the routed layer is held
    against the plain twin (GEMM tolerance); its bound counts the weights
    of the chosen experts only."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    projs, cases = _mixtral_layer(gen)
    takes_rows = "rows" in inspect.signature(grouped.grouped_mul).parameters
    rows = cases["routed"][2]
    out = dict(rows=rows.tolist(), experts_chosen=int((rows > 0).sum()))
    for case, (x, h, r) in cases.items():
        if r is not None and not takes_rows:
            continue
        kw = {} if r is None else dict(rows=r)
        calls = [(lambda w=w, s=s, g=g, y=y: grouped.grouped_mul(
            y, w, s, g, **kw)) for (w, s, g), y in zip(projs, (x, x, h))]
        if check and r is not None:
            chosen = rows > 0
            nbytes, flops = 0, 0
            for (w, s, g), y, call in zip(projs, (x, x, h), calls):
                got = call()
                plain = grouped.grouped_mul(y, w, s, g)
                if not torch.equal(got.view(torch.int16),
                                   plain.view(torch.int16)):
                    raise AssertionError("grouped routed layer: rows changed "
                                         "the bits")
                if got[~chosen].view(torch.int16).any():
                    raise AssertionError("grouped routed layer: an expert no "
                                         "token chose is not +0")
                want = grouped.grouped_mul_reference(y, w, s, g, sid=None)
                out["max_abs_err"] = max(out.get("max_abs_err", 0.0), _close(
                    "grouped routed layer", got, want, 2 ** -7,
                    2 ** -8 * want.float().abs().max()))
                nbytes += (int(chosen.sum()) * _nbytes(w[0], s[0])
                           + _nbytes(g, y, got))
                flops += 2 * int(rows.sum()) * y.shape[2] * w.shape[2]
                del got, plain, want
            out.update(bound(nbytes, flops))
        out[case] = dict(warm_ms=sum(cuda_ms(c) for c in calls),
                         graph_ms=3 * _cold_ms(calls))
        # host time a call: the wall clock of enqueueing 100 back-to-back
        # w_down calls (the launch queue holds them all)
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                calls[2]()
            out[case]["host_us"] = (time.perf_counter() - t0) / 100 * 1e6
            torch.cuda.synchronize()
        log(f"[grouped_layer] {case} ("
            f"{'every row' if r is None else 'rows ' + str(out['rows'])}): "
            f"{out[case]['warm_ms']:.4f} ms warm, "
            f"{out[case]['graph_ms']:.4f} ms graph (w_gate + w_up + w_down); "
            f"host {out[case]['host_us']:.1f} us a call")
    return out


def _grouped_routed(res):
    """The `kernels` phase's grouped layer at cap 8, full and routed
    (_grouped_layer with its checks), kept as the grouped row's "layer":
    warm and graph times of both cases, the routed case's bound; the
    library time is the full row's bmm sum, which does the same work on
    either case."""
    out = _grouped_layer(check=True)
    row = res["grouped_fp4_gemm"]
    row["max_abs_err"] = max(row["max_abs_err"], out.pop("max_abs_err"))
    row["layer"] = dict(out, library_ms=row["library_ms"])
    log(f"[kernels] grouped layer mxfp4 cap=8, {out['experts_chosen']} of "
        f"{MIXTRAL_8X7B.num_experts} experts chosen: routed "
        f"{out['routed']['graph_ms']:.4f} ms graph, full "
        f"{out['full']['graph_ms']:.4f} ms graph; bmm "
        f"{row['library_ms']:.4f} ms; routed bound {out['bound_ms']:.4f} ms")


def _w4a8_launch(a_i8, arow, words, r_t, acol, gs, out, sid):
    """One bare launch of a W4A8 kernel (the weight cache's for a
    weight_cache sid) on activations quantized beforehand, at the default
    k-splits: the kernel's own time, without fused_mul_w4a8's torch glue,
    and not counted as a launch of the path."""
    fused.launch_w4a8(a_i8, arow, words, r_t, acol, gs, out, sid)


def _int_mm_col(a_i8, b_i8):
    """torch._int_mm with B column-major (cuBLASLt's int8 layout), or None
    where this torch refuses the shapes."""
    b_col = b_i8.t().contiguous().t()
    try:
        torch._int_mm(a_i8, b_col)
    except RuntimeError as e:
        log(f"[kernels] torch._int_mm refused {tuple(a_i8.shape)} x "
            f"{tuple(b_i8.shape)}: {str(e).splitlines()[0]}")
        return None
    return lambda: torch._int_mm(a_i8, b_col)


_W4A8_ROWS = ("fp4_gemm_w4a8", "fp4_gemm_w4a8_wc", "fp4_gemm_wc",
              "fp4_gemm_prefill")


def _w4a8_kernels(rec, res, rows, gen):
    """The W4A8 GEMM (A), its weight-cache variant (B) and the bf16
    weight-cache GEMM (C) at prefill: the four Llama-3-8B projections at
    m = 512 and 2048 in nvfp4, and wqkv at m = 512 in mxfp4. A equals its
    twin bit for bit, B equals A, C equals fp4_gemm at the same tile, and
    A is within 0.03 (relative Frobenius) of fp4_gemm, and fp4_gemm (D, the
    64-row wgmma tiles at these m) is within the GEMM tolerance of its
    twin. B and C are reached through gemm.mul_*_a8 / mul_*_a16 with
    explicit weight-cache ids (the autotuner's route). Times: A and B as
    bare launches on activations quantized beforehand (the wrapper,
    quantization included, beside them), C, fp4_gemm at its default tile,
    the twins, and the library calls: torch._int_mm on the requantized
    int8 weights (A, B), torch.matmul on the dequantized bf16 weights (C,
    D). The JSON rows: nvfp4 m = 2048 summed over the four projections
    (one layer of a 4 x 512 admission), fp4_gemm_prefill for D. Then a
    sweep of m, each kernel summed over the four projections: fused_mul
    against mul_nvfp4_a8 with precomputed constants, activation
    quantization included: the crossover."""
    dev = torch.device("cuda")
    i8 = solution_mod.MatmulType.INT8
    sums = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0,
                       flops=0, err=0.0) for name in _W4A8_ROWS}
    kept = []
    for fmt, (k, n), ms in ([("nvfp4", kn, (512, 2048)) for kn in LLAMA8B_KN]
                            + [("mxfp4", LLAMA8B_KN[0], (512,))]):
        eb = ElementB.NVFP4 if fmt == "nvfp4" else ElementB.MXFP4
        quant, group = ((qref.quantize_nvfp4, 16) if fmt == "nvfp4"
                        else (qref.quantize_mxfp4, 32))
        mul8, mul16 = ((gemm.mul_nvfp4_a8, gemm.mul_nvfp4_a16)
                       if fmt == "nvfp4"
                       else (gemm.mul_mxfp4_a8, gemm.mul_mxfp4_a16))
        w = torch.randn((n, k), generator=gen, device=dev) / math.sqrt(k)
        qw, sc, gs = quant(w)
        del w
        words = layout.repack_fp4_weights(qw, n, k,
                                          pad_to=layout.pad_multiple(group))
        st = layout.process_fp4_scales(sc, n, k, group_size=group)
        gs = gs.reshape(1)
        r_t, acol = fused.w4a8_requant_constants(st)
        deq = (layout.dequant_from_tpu_layout(words, st, n, k)
               * gs).to(torch.bfloat16)
        b_i8 = fused.requantized_weights(words, r_t, k)
        if fmt == "nvfp4":
            kept.append((k, n, words, st, gs, r_t, acol))
        for m in ms:
            a = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            sid = solution_mod.choose_default_solution(m, n, k, eb, i8)
            wc8 = dataclasses.replace(sid, weight_cache=True)
            sid16 = solution_mod.choose_default_solution(m, n, k, eb)
            wc16 = dataclasses.replace(sid16, weight_cache=True)
            got = fused.fused_mul_w4a8(a, words, st, gs, sid=sid, r_t=r_t,
                                       acol=acol)
            want = fused.fused_mul_w4a8_reference(a, words, st, gs, sid=sid,
                                                  r_t=r_t, acol=acol)
            wc_wgmma0 = fused.fused_mul_w4a8_wc.wgmma_launches
            got_b = mul8(a, words, st, gs, m, n, k, wc8.repr(), r_t=r_t,
                         acol=acol)
            if fused.fused_mul_w4a8_wc.wgmma_launches != wc_wgmma0 + 1:
                raise AssertionError(f"w4a8 weight cache m={m} k={k} n={n}: "
                                     "the launch missed the 64-row int8 "
                                     "wgmma tiles")
            exact = fused.fused_mul(a, words, st, gs, sid=sid16)
            got_c = mul16(a, words, st, gs, m, n, k, wc16.repr())
            plain16 = fused.fused_mul_reference(a, words, st, gs, sid=sid16)
            torch.cuda.synchronize()
            what = f"w4a8 {fmt} m={m} k={k} n={n}"
            # each row's error against its twin: 0 for the W4A8 kernels,
            # fp4_gemm's tolerance for the bf16 weight-cache kernel
            errs = dict(
                fp4_gemm_w4a8=(got.float() - want.float()).abs().max().item(),
                fp4_gemm_w4a8_wc=(got_b.float() - want.float()).abs().max()
                .item(),
                fp4_gemm_wc=_close(f"{what} bf16 weight cache", got_c,
                                   plain16, 2 ** -7,
                                   2 ** -8 * plain16.float().abs().max()),
                fp4_gemm_prefill=_close(f"{what} fp4_gemm", exact, plain16,
                                        2 ** -7,
                                        2 ** -8 * plain16.float().abs().max()))
            for name, e in errs.items():
                sums[name]["err"] = max(sums[name]["err"], e)
            for x, y, other in ((got, want, "its twin"),
                                (got_b, got, "fp4_gemm_w4a8"),
                                (got_c, exact, "fp4_gemm")):
                if not torch.equal(x.view(torch.int16), y.view(torch.int16)):
                    raise AssertionError(f"{what}: differs from {other} "
                                         "bit for bit")
            rel = ((got.float() - exact.float()).norm()
                   / exact.float().norm()).item()
            if not rel < 0.03:
                raise AssertionError(f"{what}: relative error {rel} against "
                                     "fp4_gemm >= 0.03")
            a_i8, arow = fused.quantize_activations(a)
            out = torch.empty_like(got)
            t = dict(
                w4a8=cuda_ms(lambda: _w4a8_launch(
                    a_i8, arow, words, r_t, acol, gs, out, sid)),
                w4a8_wc=cuda_ms(lambda: _w4a8_launch(
                    a_i8, arow, words, r_t, acol, gs, out, wc8)),
                w4a8_wrapper=cuda_ms(lambda: fused.fused_mul_w4a8(
                    a, words, st, gs, sid=sid, r_t=r_t, acol=acol)),
                wc=cuda_ms(lambda: fused.fused_mul(a, words, st, gs,
                                                   sid=wc16)),
                fp4_gemm=cuda_ms(lambda: fused.fused_mul(a, words, st, gs,
                                                         sid=sid16)),
                plain_w4a8=cuda_ms(lambda: fused.fused_mul_w4a8_reference(
                    a, words, st, gs, sid=sid, r_t=r_t, acol=acol),
                    iters=2, warmup=1),
                plain=cuda_ms(lambda: fused.fused_mul_reference(
                    a, words, st, gs, sid=sid16), iters=2, warmup=1),
                matmul=cuda_ms(lambda: torch.matmul(a, deq)))
            int_mm = _int_mm_col(a_i8, b_i8)
            t["int_mm"] = cuda_ms(int_mm) if int_mm else None
            ops = 2 * m * n * k
            nb8 = _nbytes(a_i8, arow, words, r_t, acol, gs, got)
            nb16 = _nbytes(a, words, st, gs, got)
            row = dict(kernel="fp4_gemm_w4a8", fmt=fmt, m=m, k=k, n=n,
                       tile=[sid.block_m, sid.block_n],
                       tile_bf16=[sid16.block_m, sid16.block_n],
                       rel_err_vs_fp4_gemm=rel,
                       **{f"{key}_ms": v for key, v in t.items()},
                       bound_int8=bound(nb8, ops, INT8_OP_PER_S),
                       bound_bf16=bound(nb16, ops))
            rows.append(row)
            log(f"[kernels] {what} tile={sid.block_m}x{sid.block_n} "
                f"bit-equal (twin, wc, bf16 wc = fp4_gemm); bf16 wc err "
                f"{errs['fp4_gemm_wc']:.2e}; rel err {rel:.4f}; w4a8={t['w4a8']:.4f} wc={t['w4a8_wc']:.4f} "
                f"wrapper={t['w4a8_wrapper']:.4f} bf16_wc={t['wc']:.4f} "
                f"fp4_gemm={t['fp4_gemm']:.4f} int_mm={t['int_mm']} "
                f"matmul={t['matmul']:.4f} plain={t['plain_w4a8']:.2f}/"
                f"{t['plain']:.2f} ms; bound "
                f"{row['bound_int8']['bound_ms']:.4f} ms int8, "
                f"{row['bound_bf16']['bound_ms']:.4f} ms bf16")
            if fmt == "nvfp4" and m == 2048:
                for name, ms_, plain, lib, nb, peak in (
                        ("fp4_gemm_w4a8", t["w4a8"], t["plain_w4a8"],
                         t["int_mm"], nb8, INT8_OP_PER_S),
                        ("fp4_gemm_w4a8_wc", t["w4a8_wc"], t["plain_w4a8"],
                         t["int_mm"], nb8, INT8_OP_PER_S),
                        ("fp4_gemm_wc", t["wc"], t["plain"], t["matmul"],
                         nb16, BF16_FLOP_PER_S),
                        ("fp4_gemm_prefill", t["fp4_gemm"], t["plain"],
                         t["matmul"], nb16, BF16_FLOP_PER_S)):
                    acc = sums[name]
                    acc["ms"] += ms_
                    acc["plain_ms"] += plain
                    acc["library_ms"] = (None if lib is None
                                         or acc["library_ms"] is None
                                         else acc["library_ms"] + lib)
                    acc["nbytes"] += nb
                    acc["flops"] += ops
                    acc["peak"] = peak
            del a, got, want, got_b, exact, got_c, plain16, a_i8, arow, out
        if (k, n) == LLAMA8B_KN[0]:
            _w4a8_partial_group(fmt, gen, words, st, gs, r_t, acol, eb)
        del deq, b_i8
    body = {"fp4_gemm_w4a8": "the 64-row int8 wgmma tiles of "
                             "csrc/w4a8_wgmma.cuh",
            "fp4_gemm_w4a8_wc": "the 64-row int8 wgmma tiles of "
                                "csrc/w4a8_wgmma.cuh, G m-tiles a CTA "
                                "sharing one requantization",
            "fp4_gemm_wc": "the 64-row wgmma tiles of csrc/fp4_wgmma.cuh",
            "fp4_gemm_prefill": "the 64-row wgmma tiles of "
                                "csrc/fp4_wgmma.cuh"}
    lib = {"fp4_gemm_w4a8": "torch._int_mm on the requantized int8 weights",
           "fp4_gemm_w4a8_wc": "torch._int_mm on the requantized int8 "
                               "weights",
           "fp4_gemm_wc": "torch.matmul on the dequantized bf16 weights",
           "fp4_gemm_prefill": "torch.matmul on the dequantized bf16 "
                               "weights"}
    for name, acc in sums.items():
        res[name] = dict(
            max_abs_err=acc["err"], ms=acc["ms"], plain_ms=acc["plain_ms"],
            library_ms=acc["library_ms"],
            **bound(acc["nbytes"], acc["flops"], acc["peak"]),
            at=f"nvfp4 m=2048, sum of the 4 Llama-3-8B projections at the "
               f"default tile, {body[name]}" + (
                   "" if name in ("fp4_gemm_w4a8", "fp4_gemm_prefill")
                   else ", bit-equal to its non-cache counterpart") +
               f"; error against its twin (the W4A8 kernels bit-equal); "
               f"library: {lib[name]}")
        log(f"[kernels] {name} (nvfp4 m=2048, 4 projections; "
            f"{body[name]}): kernel {acc['ms']:.4f} ms, library "
            f"{acc['library_ms']} ms, bound {res[name]['bound_ms']:.4f} ms "
            f"({res[name]['bound_by']})")
    sweep = []
    for m in (16, 32, 64, 128, 256, 384, 512, 1024, 2048):
        exact_ms = w4a8_ms = 0.0
        for k, n, words, st, gs, r_t, acol in kept:
            a = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            exact_ms += cuda_ms(lambda: gemm.mul_nvfp4_a16(
                a, words, st, gs, m, n, k))
            w4a8_ms += cuda_ms(lambda: gemm.mul_nvfp4_a8(
                a, words, st, gs, m, n, k, r_t=r_t, acol=acol))
        sweep.append(dict(m=m, fp4_gemm_ms=exact_ms, w4a8_ms=w4a8_ms))
        log(f"[kernels] crossover m={m:5d}: 4 projections fp4_gemm "
            f"{exact_ms:.4f} ms, W4A8 (quantization included) "
            f"{w4a8_ms:.4f} ms, ratio {exact_ms / w4a8_ms:.3f}")
    rec["w4a8_sweep"] = sweep
    _small_tile_rows(res, kept, gen)
    rec["fp4_wc_sweep"] = _fp4_wc_16row(res, kept, gen)


def _w4a8_partial_group(fmt, gen, words, st, gs, r_t, acol, eb):
    """The weight cache's 64-row tiles at m = 200 and 300, whose last
    m-group is partial (rows past m zero-filled and never stored), at
    both widths: bit for bit the plain kernel and the twin, each launch
    counted as a wgmma launch."""
    k, n = words.shape[0] * 8, words.shape[1]
    i8 = solution_mod.MatmulType.INT8
    for m in (200, 300):
        a = torch.randn((m, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        want = fused.fused_mul_w4a8_reference(
            a, words, st, gs, sid=solution_mod.SolutionId(64, 128, eb, i8),
            r_t=r_t, acol=acol)
        for bn in (64, 128):
            sid = solution_mod.SolutionId(64, bn, eb, i8)
            wc = dataclasses.replace(sid, weight_cache=True)
            plain = fused.fused_mul_w4a8(a, words, st, gs, sid=sid, r_t=r_t,
                                         acol=acol)
            before = fused.fused_mul_w4a8_wc.wgmma_launches
            got = fused.fused_mul_w4a8(a, words, st, gs, sid=wc, r_t=r_t,
                                       acol=acol)
            torch.cuda.synchronize()
            what = f"w4a8 weight cache {fmt} m={m} k={k} n={n} tile=64x{bn}"
            if fused.fused_mul_w4a8_wc.wgmma_launches != before + 1:
                raise AssertionError(f"{what}: missed the int8 wgmma tiles")
            for other, ref in (("the plain kernel", plain), ("its twin", want)):
                if not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
                    raise AssertionError(f"{what}: differs from {other}")
        log(f"[kernels] w4a8 weight cache {fmt} m={m} (partial last m-group) "
            "bit-equal to the plain kernel and the twin at 64x64 and 64x128")


# the W4A8 16-row tiles that no other row times: (name, m, weight cache)
_SMALL_TILES = (("fp4_gemm_w4a8_16row", 16, False),
                ("fp4_gemm_w4a8_wc_16row", 64, True))


def _small_tile_rows(res, kept, gen):
    """The W4A8 16-row tiles no other row times: the plain tile at m = 16
    and its weight cache at m = 64 (4 m-tiles of 16 a CTA), both on the
    split-k int8 stream body at their default splits; nvfp4, 16x64 tiles,
    summed over the four Llama-3-8B projections: bit for bit their twin,
    through the wrapper, whose launch must count as a stream launch, timed
    warm (back to back) and as one CUDA graph of the four (graph_ms: 136
    MB of weights, so each launch finds its own cold), beside the twin and
    torch._int_mm on the requantized int8 weights (it refuses m <= 16, so
    at m = 16 on A zero-padded to 32 rows, labelled so). No engine path
    launches them."""
    dev = torch.device("cuda")
    for name, m, wc in _SMALL_TILES:
        acc = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0, flops=0)
        calls, lib_note = [], ""
        for k, n, words, st, gs, r_t, acol in kept:
            a = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            sid = solution_mod.SolutionId(16, 64, ElementB.NVFP4,
                                          solution_mod.MatmulType.INT8,
                                          weight_cache=wc)
            wrapper = fused.fused_mul_w4a8_wc if wc else fused.fused_mul_w4a8
            before = wrapper.stream_launches
            got = fused.fused_mul_w4a8(a, words, st, gs, sid=sid, r_t=r_t,
                                       acol=acol)
            if wrapper.stream_launches != before + 1:
                raise AssertionError(f"{name} k={k} n={n}: the launch missed "
                                     "the 16-row stream tiles")
            want = fused.fused_mul_w4a8_reference(a, words, st, gs, sid=sid,
                                                  r_t=r_t, acol=acol)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
                raise AssertionError(f"{name} k={k} n={n}: differs from its "
                                     "twin")
            a_i8, arow = fused.quantize_activations(a)
            out = torch.empty_like(got)
            call = (lambda a_i8=a_i8, arow=arow, w=words, r=r_t, c=acol,
                    g=gs, o=out, sid=sid:
                    _w4a8_launch(a_i8, arow, w, r, c, g, o, sid))
            t_p = cuda_ms(lambda: fused.fused_mul_w4a8_reference(
                a, words, st, gs, sid=sid, r_t=r_t, acol=acol),
                iters=2, warmup=1)
            a_lib = a_i8
            if m <= 16:   # _int_mm refuses m <= 16: pad A with zero rows
                a_lib = torch.zeros((32, k), dtype=torch.int8, device=dev)
                a_lib[:m] = a_i8
                lib_note = ("torch._int_mm on the requantized int8 weights, "
                            "A zero-padded to 32 rows (it refuses m <= 16)")
            else:
                lib_note = "torch._int_mm on the requantized int8 weights"
            lib = _int_mm_col(a_lib, fused.requantized_weights(words, r_t, k))
            t_k = cuda_ms(call)
            calls.append(call)
            t_l = cuda_ms(lib) if lib else None
            acc["ms"] += t_k
            acc["plain_ms"] += t_p
            acc["library_ms"] = (None if t_l is None or acc["library_ms"] is
                                 None else acc["library_ms"] + t_l)
            acc["nbytes"] += _nbytes(a_i8, arow, words, r_t, acol, gs, got)
            acc["flops"] += 2 * m * n * k
            log(f"[kernels] {name} m={m} k={k} n={n}: kernel {t_k:.4f} ms, "
                f"plain {t_p:.2f} ms, library {t_l} ms")
        graph_ms = len(calls) * _cold_ms(calls)
        body = ("the split-k int8 stream body of csrc/w4a8_stream.cuh at the "
                "default splits")
        res[name] = dict(
            max_abs_err=0.0, ms=acc["ms"], graph_ms=graph_ms,
            plain_ms=acc["plain_ms"], library_ms=acc["library_ms"],
            **bound(acc["nbytes"], acc["flops"], INT8_OP_PER_S),
            at=f"nvfp4 m={m}, sum of the 4 Llama-3-8B projections, tile 16x64"
               f"{', weight cache (4 m-tiles a CTA)' if wc else ''}, {body}; "
               f"ms back to back, graph_ms a CUDA graph of the four; "
               f"library: {lib_note}")
        log(f"[kernels] {name} (nvfp4 m={m}, 4 projections; {body}): kernel "
            f"{acc['ms']:.4f} ms warm, {graph_ms:.4f} ms graph, plain "
            f"{acc['plain_ms']:.2f} ms, library {acc['library_ms']} ms "
            f"({lib_note}), bound {res[name]['bound_ms']:.4f} ms "
            f"({res[name]['bound_by']})")


def _fp4_wc_16row(res, kept, gen, m=64):
    """The FP4 weight cache's 16-row tiles (fused_mul_wc at block_m 16:
    fp4_stream_kernel<BN, 4>, 4 m-tiles a CTA sharing each decoded B
    fragment) at m = 64, nvfp4, the four Llama-3-8B projections, 16x64 and
    16x128 at their default splits: each launch counted as a stream launch,
    bit for bit fused_mul's plain 16-row tile at the same tile and splits,
    within the GEMM tolerance of the twin; timed warm (back to back) and as
    one CUDA graph of the four (each launch finds its weights cold), beside
    the twin and torch.matmul on the dequantized bf16 weights, summed over
    the four. The row fp4_gemm_wc_16row is 16x64 (ms_16x128, graph_ms_16x128
    the other width). Then the sweep of 1 to 8 splits at 16x64; returns it."""
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    acc = dict(plain_ms=0.0, library_ms=0.0, nbytes=0, flops=0, err=0.0)
    layer, widths = [], {}
    for k, n, words, st, gs, _, _ in kept:
        kp = words.shape[0] * 8
        a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        want = fused.fused_mul_reference(a, words, st, gs, sid=None)
        for bn in (64, 128):
            sid = solution_mod.SolutionId(16, bn, ElementB.NVFP4,
                                          weight_cache=True)
            splits = fused.fp4_wc_splits(m, n, kp, sid, sms)
            before = fused.fused_mul_wc.stream_launches
            got = fused.fused_mul(a, words, st, gs, sid=sid)
            if fused.fused_mul_wc.stream_launches != before + 1:
                raise AssertionError(f"fp4_gemm_wc_16row k={k} n={n}: the "
                                     "launch missed the 16-row stream tiles")
            plain = fused.fused_mul(
                a, words, st, gs, sid=dataclasses.replace(
                    sid, weight_cache=False), splits=splits)
            torch.cuda.synchronize()
            what = f"fp4_gemm_wc_16row k={k} n={n} tile=16x{bn} splits={splits}"
            if not torch.equal(got.view(torch.int16), plain.view(torch.int16)):
                raise AssertionError(f"{what}: differs from the plain 16-row "
                                     "tile at the same splits")
            acc["err"] = max(acc["err"], _close(
                what, got, want, 2 ** -7, 2 ** -8 * want.float().abs().max()))
            call = (lambda a=a, w=words, s_=st, g=gs, sid=sid:
                    fused.fused_mul(a, w, s_, g, sid=sid))
            t_k = cuda_ms(call)
            w_ = widths.setdefault(bn, dict(ms=0.0, calls=[], splits=[]))
            w_["ms"] += t_k
            w_["calls"].append(call)
            w_["splits"].append(splits)
            log(f"[kernels] {what}: bit-equal to the plain tile, err "
                f"{acc['err']:.2e}; kernel {t_k:.4f} ms")
        deq = (layout.dequant_from_tpu_layout(words, st, n, k)
               * gs).to(torch.bfloat16)
        acc["plain_ms"] += cuda_ms(lambda: fused.fused_mul_reference(
            a, words, st, gs, sid=None), iters=2, warmup=1)
        acc["library_ms"] += cuda_ms(lambda: torch.matmul(a, deq))
        acc["nbytes"] += _nbytes(a, words, st, gs, want)
        acc["flops"] += 2 * m * n * k
        layer.append((a, words, st, gs))
        del deq, want
    for w_ in widths.values():
        w_["graph_ms"] = len(w_["calls"]) * _cold_ms(w_["calls"])
    body = ("the split-k stream body of csrc/fp4_stream.cuh, 4 m-tiles a CTA "
            "sharing each decoded B fragment, at the default splits")
    res["fp4_gemm_wc_16row"] = dict(
        max_abs_err=acc["err"], ms=widths[64]["ms"],
        graph_ms=widths[64]["graph_ms"], splits=widths[64]["splits"],
        ms_16x128=widths[128]["ms"], graph_ms_16x128=widths[128]["graph_ms"],
        splits_16x128=widths[128]["splits"], plain_ms=acc["plain_ms"],
        library_ms=acc["library_ms"], **bound(acc["nbytes"], acc["flops"]),
        at=f"nvfp4 m={m}, sum of the 4 Llama-3-8B projections, tile 16x64 "
           f"weight cache, {body}, bit-equal to fused_mul's plain 16-row "
           "tile at the same splits; ms back to back, graph_ms a CUDA graph "
           "of the four (ms_16x128, graph_ms_16x128: tile 16x128); library: "
           "torch.matmul on the dequantized bf16 weights")
    r = res["fp4_gemm_wc_16row"]
    log(f"[kernels] fp4_gemm_wc_16row (nvfp4 m={m}, 4 projections; {body}): "
        f"16x64 {r['ms']:.4f} ms warm, {r['graph_ms']:.4f} ms graph (splits "
        f"{r['splits']}); 16x128 {r['ms_16x128']:.4f} warm, "
        f"{r['graph_ms_16x128']:.4f} graph (splits {r['splits_16x128']}); "
        f"plain {r['plain_ms']:.2f} ms, matmul {r['library_ms']:.4f} ms, "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return _wc_split_sweep(layer)


def _wc_split_sweep(layer, counts=range(1, 9)):
    """The FP4 weight cache's 16x64 tiles at each split count in `counts`
    on the four Llama-3-8B projections at m = 64 (layer: (a, words, st, gs)
    each): per projection L2-warm, the four as one CUDA graph, each output
    bit for bit fused_mul's plain 16-row tile at the same count."""
    out = []
    for sf in counts:
        entry = dict(splits=sf, projections=[])
        calls = []
        for a, words, st, gs in layer:
            n = words.shape[1]
            sf_ = min(sf, words.shape[0] * 8 // fused.KSTEP)
            sid = solution_mod.SolutionId(16, 64, ElementB.NVFP4,
                                          weight_cache=True)
            call = (lambda a=a, w=words, s_=st, g=gs, sid=sid, sf_=sf_:
                    fused.fused_mul(a, w, s_, g, sid=sid, splits=sf_))
            plain = fused.fused_mul(a, words, st, gs, sid=dataclasses.replace(
                sid, weight_cache=False), splits=sf_)
            if not torch.equal(call().view(torch.int16),
                               plain.view(torch.int16)):
                raise AssertionError(f"wc sweep splits={sf_} n={n}: differs "
                                     "from the plain 16-row tile")
            calls.append(call)
            entry["projections"].append(dict(k=a.shape[1], n=n,
                                             warm_ms=cuda_ms(call)))
        entry["warm_ms"] = sum(p["warm_ms"] for p in entry["projections"])
        entry["graph_ms"] = len(calls) * _cold_ms(calls)
        out.append(entry)
        log(f"[kernels] wc sweep splits={sf} (m=64, 16x64, bit-equal to the "
            "plain tile): " + ", ".join(
                f"n={p['n']} k={p['k']} {p['warm_ms']:.4f}"
                for p in entry["projections"])
            + f" ms warm; layer {entry['warm_ms']:.4f} warm, "
            f"{entry['graph_ms']:.4f} graph")
    return out


def _dequant_kernels(res, rows, gen):
    """The dequant kernel (the backward pass of mul_fp4_diff) at the four
    Llama-3-8B projections, nvfp4 and mxfp4, bit for bit against its twin.
    No single PyTorch call decodes this layout: no library time. The JSON
    row is nvfp4 summed over the four (one layer's backward)."""
    dev = torch.device("cuda")
    sums = dict(ms=0.0, plain_ms=0.0, nbytes=0)
    for fmt in ("nvfp4", "mxfp4"):
        quant, group = ((qref.quantize_nvfp4, 16) if fmt == "nvfp4"
                        else (qref.quantize_mxfp4, 32))
        for k, n in LLAMA8B_KN:
            w = torch.randn((n, k), generator=gen, device=dev) / math.sqrt(k)
            qw, sc, _ = quant(w)
            del w
            words = layout.repack_fp4_weights(
                qw, n, k, pad_to=layout.pad_multiple(group))
            st = layout.process_fp4_scales(sc, n, k, group_size=group)
            got = fused.dequant_tpu_layout(words, st)
            want = fused.dequant_tpu_layout_reference(words, st)
            torch.cuda.synchronize()
            what = f"dequant {fmt} k={k} n={n}"
            if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
                raise AssertionError(f"{what}: differs from its twin")
            del want
            t_k = cuda_ms(lambda: fused.dequant_tpu_layout(words, st))
            t_p = cuda_ms(lambda: fused.dequant_tpu_layout_reference(
                words, st), iters=2, warmup=1)
            nbytes = _nbytes(words, st, got)
            row = dict(kernel="fp4_dequant", fmt=fmt, k=k, n=n,
                       max_abs_err=0.0, ms=t_k, plain_ms=t_p,
                       library_ms=None, **bound(nbytes, 0))
            rows.append(row)
            log(f"[kernels] {what} bit-exact kernel={t_k:.4f} ms "
                f"plain={t_p:.4f} ms bound={row['bound_ms']:.4f} ms "
                f"({nbytes / t_k / 1e6:.0f} GB/s)")
            if fmt == "nvfp4":
                sums["ms"] += t_k
                sums["plain_ms"] += t_p
                sums["nbytes"] += nbytes
            del got, words, st
    res["fp4_dequant"] = dict(
        max_abs_err=0.0, ms=sums["ms"], plain_ms=sums["plain_ms"],
        library_ms=None, **bound(sums["nbytes"], 0),
        at="nvfp4, sum of the 4 Llama-3-8B projections (one layer's "
           "backward), bit-exact; library: none, no PyTorch call decodes "
           "this layout")


def _hybrid_operands(k, n, gen):
    """A random (k, n) weight split 3:1 on the card as quantize_params(...,
    "hybrid") splits it: (words, scales, gs (1,), wd)."""
    w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
    hq = llama.quantize_linear(w, "hybrid")
    return hq["words"], hq["scales"], hq["gs"].reshape(1), hq["wd"]


def _flushed_ms(fn) -> float:
    """Median ms of single calls of fn with L2 flushed before each."""
    return benchlib.cuda_time(fn) * 1e3


def _cold_ms(calls, reps: int = 24) -> float:
    """Device ms a call of a CUDA graph that runs `calls` round robin, reps
    launches a replay; the median of 5 replays. Each call closes over its
    own copy of the weights, the copies together larger than the 50 MB L2,
    so every call finds its weights cold, as a decode step does, with no
    flush writing back beside it and no host time in the graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call in calls:
            call()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            calls[i % len(calls)]()
    graph.replay()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return sorted(times)[2]


def _hybrid_cold_ms(a, words, st, gs, wd, **kw) -> float:
    """_cold_ms of hybrid_mul over copies of (words, st, wd) that fill 120
    MB."""
    nbytes = _nbytes(words, st, wd)
    copies = [(words, st, wd)] + [
        (words.clone(), st.clone(), wd.clone())
        for _ in range(max(2, math.ceil(120e6 / nbytes)) - 1)]
    return _cold_ms([(lambda w=w, s=s, d=d: hybrid.hybrid_mul(
        a, w, s, gs, d, **kw)) for w, s, d in copies])


def _graph_ms(fn, reps: int = 20) -> float:
    """Device ms a call of a CUDA graph of `reps` launches of fn, L2-warm
    (one set of operands): no host time between the launches, which a
    back-to-back mean of calls shorter than their host time includes."""
    return _cold_ms([fn], reps=reps)


def _hybrid_halves(a, words, st, gs, wd, sid, outd):
    """The two kinds of CTAs of one 64-row hybrid launch timed apart,
    L2-warm: the dense columns alone (a launch with no FP4 columns, which
    runs only the dense CTAs; its output bit for bit the full launch's
    `outd`), their yardstick torch.matmul(a, wd[:k]) and the work of
    their bound, and the FP4 columns alone (fused_mul at the same tile
    runs the same body as the FP4 CTAs). Back-to-back means (cuda_ms) and
    graph times (_graph_ms, the "graph_" keys): the dense launches of the
    small projections take less device time than the wrapper's host
    time."""
    k = a.shape[1]
    no_w, no_s = words[:, :0].contiguous(), st[:, :0].contiguous()
    dense = (lambda: hybrid.hybrid_mul(a, no_w, no_s, gs, wd, sid=sid))
    _, alone = dense()
    torch.cuda.synchronize()
    if not torch.equal(alone.view(torch.int16), outd.view(torch.int16)):
        raise AssertionError(f"hybrid m={a.shape[0]} k={k}: the dense CTAs "
                             "alone differ from the full launch's")
    wdk = wd[:k]
    lib = (lambda: torch.matmul(a, wdk))
    fp4 = (lambda: fused.fused_mul(a, words, st, gs, sid=sid))
    return dict(dense_ms=cuda_ms(dense), graph_dense_ms=_graph_ms(dense),
                dense_library_ms=cuda_ms(lib),
                graph_dense_library_ms=_graph_ms(lib),
                dense_nbytes=_nbytes(a, wdk, outd),
                dense_flops=2 * a.shape[0] * wd.shape[1] * k,
                fp4_ms=cuda_ms(fp4), graph_fp4_ms=_graph_ms(fp4))


def _hybrid_kernels(res, rows, gen):
    """The hybrid GEMM at the seven unfused Llama-3-8B projections, each
    split as quantize_params(..., "hybrid") splits it (3:1), at m = 8 and
    512, at the heuristic's tile and hybrid_splits' splits: both halves
    against the twin at the GEMM tolerance, a second launch bit for bit the
    first; the FP4 columns bit for bit fused_mul's at the same tile with
    one split (m = 8) and at m = 512 (block_m = 64, no split); at m = 8
    also 2, 3 and one split per step, against the twin and repeated. Times
    L2-warm (cuda_ms) and L2-flushed (benchlib.cuda_time). Library:
    torch.matmul of A by the whole bf16 (k, n) weight (the dequantized FP4
    columns and the dense ones side by side). The JSON row is m = 8 summed
    over the seven (one layer of a hybrid decode step), L2 flushed; at m =
    8 the rows also hold the cold-weights graph time (_cold_ms). The m =
    512 sum (64-row tiles: fp4_wgmma.cuh for the FP4 columns,
    dense_wgmma.cuh for the dense ones), L2-warm, is logged and kept as
    the row's "prefill", with the two halves timed apart (_hybrid_halves):
    "fp4_ms" and "dense", the dense columns' time beside
    torch.matmul(a, wd[:k]) and their own bound."""
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    layer = dict(ms=0.0, warm_ms=0.0, cold_ms=0.0, plain_ms=0.0,
                 library_ms=0.0, nbytes=0, flops=0)
    prefill = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0, flops=0,
                   graph_ms=0.0, dense_ms=0.0, graph_dense_ms=0.0,
                   dense_library_ms=0.0, graph_dense_library_ms=0.0,
                   dense_nbytes=0, dense_flops=0, fp4_ms=0.0,
                   graph_fp4_ms=0.0)
    err = 0.0
    tol = dict(rtol=2 ** -7)
    for k, n in dict.fromkeys(LLAMA8B_UNFUSED_KN):
        times = LLAMA8B_UNFUSED_KN.count((k, n))
        words, st, gs, wd = _hybrid_operands(k, n, gen)
        nf, nd, kp = words.shape[1], wd.shape[1], wd.shape[0]
        steps = kp // hybrid.KSTEP
        full = torch.cat([(layout.dequant_from_tpu_layout(words, st, nf, k)
                           * gs).to(torch.bfloat16), wd[:k]], dim=1)
        for m in (8, 512):
            a = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            sid = solution_mod.choose_default_solution(m, nf, k)
            sf, sd = hybrid.hybrid_splits(m, nf, nd, kp, sid.block_m,
                                          sid.block_n, sms)
            ctas = -(-m // sid.block_m) * (-(-nf // sid.block_n) * sf
                                           + -(-nd // sid.block_n) * sd)
            what = f"hybrid m={m} k={k} n={n} (nf={nf}, nd={nd})"
            plain_f = fused.fused_mul(a, words, st, gs, sid=sid, splits=1)
            want_f, want_d = hybrid.hybrid_mul_reference(a, words, st, gs, wd,
                                                         sid=sid)
            e = 0.0
            runs = [None] if sid.block_m == 64 else [None, 1, *sorted(
                {s for s in (2, 3, steps) if s <= steps})]
            for splits in runs:
                outf, outd = hybrid.hybrid_mul(a, words, st, gs, wd, sid=sid,
                                               splits=splits)
                againf, againd = hybrid.hybrid_mul(a, words, st, gs, wd,
                                                   sid=sid, splits=splits)
                torch.cuda.synchronize()
                tag = f"{what} splits={splits or (sf, sd)}"
                if not (torch.equal(outf.view(torch.int16),
                                    againf.view(torch.int16))
                        and torch.equal(outd.view(torch.int16),
                                        againd.view(torch.int16))):
                    raise AssertionError(f"{tag}: two launches differ")
                if (sid.block_m == 64 or splits == 1) and not torch.equal(
                        outf.view(torch.int16), plain_f.view(torch.int16)):
                    raise AssertionError(f"{tag}: FP4 columns differ from "
                                         "fused_mul bit for bit")
                e = max(e, _close(f"{tag} FP4 columns", outf, want_f,
                                  atol=2 ** -8 * want_f.float().abs().max(),
                                  **tol),
                        _close(f"{tag} dense columns", outd, want_d,
                               atol=2 ** -8 * want_d.float().abs().max(),
                               **tol))
            call = (lambda: hybrid.hybrid_mul(a, words, st, gs, wd, sid=sid))
            t_k = cuda_ms(call)
            t_kf = _flushed_ms(call)
            t_p = cuda_ms(lambda: hybrid.hybrid_mul_reference(
                a, words, st, gs, wd, sid=sid), iters=2, warmup=1)
            t_l = cuda_ms(lambda: torch.matmul(a, full))
            t_lf = _flushed_ms(lambda: torch.matmul(a, full))
            t_kc = (_hybrid_cold_ms(a, words, st, gs, wd, sid=sid)
                    if m == 8 else None)
            if m == 512:
                split = _hybrid_halves(a, words, st, gs, wd, sid, outd)
                split["graph_ms"] = _graph_ms(call)
                for key, v in split.items():
                    prefill[key] += times * v
            nbytes = _nbytes(a, words, st, gs, wd, want_f, want_d)
            flops = 2 * m * n * k
            row = dict(kernel="hybrid_gemm", m=m, k=k, n=n, nf=nf, nd=nd,
                       tile=[sid.block_m, sid.block_n], splits=[sf, sd],
                       ctas=ctas, max_abs_err=e, ms=t_k, flushed_ms=t_kf,
                       cold_ms=t_kc, plain_ms=t_p, library_ms=t_l,
                       library_flushed_ms=t_lf, **bound(nbytes, flops))
            rows.append(row)
            log(f"[kernels] {what} tile={sid.block_m}x{sid.block_n} "
                f"splits={sf},{sd} ctas={ctas} err={e:.2e}, repeatable, "
                f"FP4 columns bit-equal to fused_mul at one split; "
                f"kernel={t_k:.4f} ms (flushed {t_kf:.4f}"
                f"{'' if t_kc is None else f', cold {t_kc:.4f}'}) "
                f"plain={t_p:.4f} "
                f"ms matmul={t_l:.4f} ms (flushed {t_lf:.4f}) "
                f"bound={row['bound_ms']:.4f} ms ({row['bound_by']}; "
                f"{nbytes / t_kf / 1e6:.0f} GB/s flushed)")
            err = max(err, e)
            if m == 8:
                for key, v in (("ms", t_kf), ("warm_ms", t_k),
                               ("cold_ms", t_kc),
                               ("plain_ms", t_p), ("library_ms", t_lf),
                               ("nbytes", nbytes), ("flops", flops)):
                    layer[key] += times * v
            else:
                for key, v in (("ms", t_k), ("plain_ms", t_p),
                               ("library_ms", t_l), ("nbytes", nbytes),
                               ("flops", flops)):
                    prefill[key] += times * v
            del a, plain_f, want_f, want_d, outf, outd, againf, againd
        del words, st, wd, full
    res["hybrid_gemm"] = dict(
        max_abs_err=err, ms=layer["ms"], warm_ms=layer["warm_ms"],
        cold_ms=layer["cold_ms"], plain_ms=layer["plain_ms"],
        library_ms=layer["library_ms"],
        **bound(layer["nbytes"], layer["flops"]),
        at="m=8, sum of the 7 unfused Llama-3-8B projections (one layer of "
           "a hybrid decode step), 3:1 FP4:dense columns, hybrid_splits' "
           "splits; ms and library_ms L2-flushed medians (warm_ms: "
           "back-to-back mean; cold_ms: a CUDA graph over weight copies "
           "larger than L2); library: torch.matmul on the whole bf16 "
           "weight",
        prefill=dict(
            _layer_row(prefill, "m=512, the same 7 projections, L2-warm"),
            graph_ms=prefill["graph_ms"], fp4_ms=prefill["fp4_ms"],
            graph_fp4_ms=prefill["graph_fp4_ms"],
            dense=dict(ms=prefill["dense_ms"],
                       graph_ms=prefill["graph_dense_ms"],
                       library_ms=prefill["dense_library_ms"],
                       graph_library_ms=prefill["graph_dense_library_ms"],
                       **bound(prefill["dense_nbytes"],
                               prefill["dense_flops"]),
                       at="the dense columns alone (no FP4 columns), m=512, "
                          "the 7 projections, L2-warm; library: "
                          "torch.matmul(a, wd[:k])")))
    pre = res["hybrid_gemm"]["prefill"]
    log(f"[kernels] hybrid layer m=512 (7 projections, 64-row tiles): "
        f"kernel {prefill['ms']:.4f} ms warm (graph "
        f"{prefill['graph_ms']:.4f}), matmul {prefill['library_ms']:.4f} ms, "
        f"bound {pre['bound_ms']:.4f} ms ({pre['bound_by']}); FP4 columns "
        f"alone (fused_mul) {prefill['fp4_ms']:.4f} ms (graph "
        f"{prefill['graph_fp4_ms']:.4f}); dense columns alone "
        f"{prefill['dense_ms']:.4f} ms (graph {prefill['graph_dense_ms']:.4f}"
        f"), matmul(a, wd[:k]) {prefill['dense_library_ms']:.4f} ms (graph "
        f"{prefill['graph_dense_library_ms']:.4f}; graph ratio "
        f"{prefill['graph_dense_ms'] / prefill['graph_dense_library_ms']:.2f}"
        f"x), bound {pre['dense']['bound_ms']:.4f} ms "
        f"({pre['dense']['bound_by']}; "
        f"{100 * pre['dense']['bound_ms'] / prefill['graph_dense_ms']:.1f}% "
        "of the graph time)")
    log(f"[kernels] hybrid layer (m=8, 7 projections): kernel "
        f"{layer['ms']:.4f} ms flushed, {layer['warm_ms']:.4f} warm, "
        f"{layer['cold_ms']:.4f} cold (graph); matmul "
        f"{layer['library_ms']:.4f} flushed; bound "
        f"{res['hybrid_gemm']['bound_ms']:.4f} ms")


def phase_hybrid_layer(rec):
    """The hybrid GEMM's decode layer alone, for an A/B of two trees: the
    seven unfused Llama-3-8B projections at m = 8 through hybrid_mul with
    its default tile and splits, L2-warm, L2-flushed and cold (a CUDA graph
    over weight copies, _cold_ms), summed over the layer. It calls only
    llama.quantize_linear, hybrid_mul(a, words, scales, gs, wd),
    benchlib.cuda_time and torch.cuda graphs, which older trees have too, so
    a copy of this script placed in an older checkout times that tree's
    kernel."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = dict(warm_ms=0.0, flushed_ms=0.0, cold_ms=0.0, per_projection=[])
    for k, n in dict.fromkeys(LLAMA8B_UNFUSED_KN):
        times = LLAMA8B_UNFUSED_KN.count((k, n))
        words, st, gs, wd = _hybrid_operands(k, n, gen)
        a = torch.randn((8, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        call = (lambda: hybrid.hybrid_mul(a, words, st, gs, wd))
        warm, flushed = cuda_ms(call), _flushed_ms(call)
        cold = _hybrid_cold_ms(a, words, st, gs, wd)
        out["per_projection"].append(dict(k=k, n=n, warm_ms=warm,
                                          flushed_ms=flushed, cold_ms=cold))
        out["warm_ms"] += times * warm
        out["flushed_ms"] += times * flushed
        out["cold_ms"] += times * cold
        log(f"[hybrid_layer] k={k} n={n} (x{times}): {warm:.4f} ms warm, "
            f"{flushed:.4f} ms flushed, {cold:.4f} ms cold")
        del words, st, wd, a
    log(f"[hybrid_layer] layer (7 projections, m=8): {out['warm_ms']:.4f} "
        f"ms warm, {out['flushed_ms']:.4f} ms flushed, {out['cold_ms']:.4f} "
        "ms cold")
    log(json.dumps({"hybrid_layer": out}))
    rec["hybrid_layer"] = out


def phase_hybrid_prefill_layer(rec):
    """The hybrid GEMM's prefill layer alone, for an A/B of two trees: the
    seven unfused Llama-3-8B projections at m = 512 through hybrid_mul at
    the heuristic's 64-row tile, L2-warm (back-to-back and as a CUDA graph
    of 20 launches), summed over the layer, and its two halves apart
    (_hybrid_halves: the dense columns alone, their torch.matmul
    yardstick, the FP4 columns through fused_mul). It calls
    only APIs older trees have too, so a copy of this script placed in an
    older checkout times that tree's kernel."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    keys = ("ms", "graph_ms", "dense_ms", "graph_dense_ms",
            "dense_library_ms", "graph_dense_library_ms", "fp4_ms",
            "graph_fp4_ms", "dense_nbytes", "dense_flops")
    out = dict.fromkeys(keys, 0.0)
    out["per_projection"] = []
    for k, n in dict.fromkeys(LLAMA8B_UNFUSED_KN):
        times = LLAMA8B_UNFUSED_KN.count((k, n))
        words, st, gs, wd = _hybrid_operands(k, n, gen)
        a = torch.randn((512, k), generator=gen, device=dev).to(
            torch.bfloat16)
        sid = solution_mod.choose_default_solution(512, words.shape[1], k)
        call = (lambda: hybrid.hybrid_mul(a, words, st, gs, wd, sid=sid))
        _, outd = call()
        row = dict(k=k, n=n, tile=[sid.block_m, sid.block_n],
                   ms=cuda_ms(call), graph_ms=_graph_ms(call),
                   **_hybrid_halves(a, words, st, gs, wd, sid, outd))
        out["per_projection"].append(row)
        for key in keys:
            out[key] += times * row[key]
        log(f"[hybrid_prefill_layer] k={k} n={n} (x{times}) "
            f"tile={sid.block_m}x{sid.block_n}: {row['ms']:.4f} ms (graph "
            f"{row['graph_ms']:.4f}); dense alone {row['dense_ms']:.4f} "
            f"(graph {row['graph_dense_ms']:.4f}; matmul "
            f"{row['dense_library_ms']:.4f}, graph "
            f"{row['graph_dense_library_ms']:.4f}), FP4 alone "
            f"{row['fp4_ms']:.4f} (graph {row['graph_fp4_ms']:.4f})")
        del words, st, wd, a, outd
    out["dense_bound"] = bound(out["dense_nbytes"], out["dense_flops"])
    log(f"[hybrid_prefill_layer] layer (7 projections, m=512): "
        f"{out['ms']:.4f} ms (graph {out['graph_ms']:.4f}); dense columns "
        f"alone {out['dense_ms']:.4f} ms (graph {out['graph_dense_ms']:.4f}),"
        f" matmul(a, wd[:k]) {out['dense_library_ms']:.4f} ms (graph "
        f"{out['graph_dense_library_ms']:.4f}), bound "
        f"{out['dense_bound']['bound_ms']:.4f} ms; FP4 columns alone "
        f"{out['fp4_ms']:.4f} ms (graph {out['graph_fp4_ms']:.4f})")
    rec["hybrid_prefill_layer"] = out


def phase_w4a8_layer(rec):
    """The W4A8 GEMM's tiles alone, for an A/B of two trees or of edited
    copies of csrc/w4a8_wgmma.cuh or csrc/w4a8_stream.cuh: the four
    Llama-3-8B projections (nvfp4), each a bare launch of pk_fp4_gemm_w4a8
    and of its weight cache pk_fp4_gemm_w4a8_wc on activations quantized
    beforehand (_w4a8_launch), L2-warm, summed over the four: the 64-row
    tiles (64x64, 64x128) at m = 512 and 2048; the 16-row tiles (16x64,
    16x128) at their default splits, the plain tile at m = 16 and the
    weight cache at m = 64, also as one CUDA graph of the four (each
    launch finds its weights cold). Times only: the kernels phase checks
    the bits."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out, graphs = {}, {}
    i8 = solution_mod.MatmulType.INT8
    for k, n in LLAMA8B_KN:
        w = torch.randn((n, k), generator=gen, device=dev) / math.sqrt(k)
        qw, sc, gs = qref.quantize_nvfp4(w)
        del w
        words = layout.repack_fp4_weights(qw, n, k,
                                          pad_to=layout.pad_multiple(16))
        st = layout.process_fp4_scales(sc, n, k, group_size=16)
        gs = gs.reshape(1)
        r_t, acol = fused.w4a8_requant_constants(st)
        runs = [(m, bm, bn, wc) for m in (512, 2048)
                for bm, bn in ((64, 64), (64, 128)) for wc in (False, True)]
        runs += [(m, 16, bn, m == 64) for bn in (64, 128) for m in (16, 64)]
        for m in sorted({r[0] for r in runs}):
            a = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            a_i8, arow = fused.quantize_activations(a)
            y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
            for m_, bm, bn, wc in runs:
                if m_ != m:
                    continue
                sid = solution_mod.SolutionId(bm, bn, ElementB.NVFP4, i8,
                                              weight_cache=wc)
                key = f"m={m} tile={bm}x{bn}{' weight cache' if wc else ''}"
                call = (lambda a_i8=a_i8, arow=arow, w=words, r=r_t, c=acol,
                        g=gs, o=y, sid=sid:
                        _w4a8_launch(a_i8, arow, w, r, c, g, o, sid))
                out[key] = out.get(key, 0.0) + cuda_ms(call)
                if bm == 16:
                    graphs.setdefault(key, []).append(call)
    for key, t in out.items():
        log(f"[w4a8_layer] {key}: 4 projections {t:.4f} ms")
    for key, calls in graphs.items():
        out[f"{key} graph"] = t = len(calls) * _cold_ms(calls)
        log(f"[w4a8_layer] {key}: 4 projections {t:.4f} ms as a CUDA graph")
    rec["w4a8_layer"] = out


def phase_fp4_wc_layer(rec):
    """The FP4 weight cache's 16-row tiles alone, for an A/B of two trees or
    of copies of csrc/fp4_stream.cuh with another plan (warps, ring depth):
    the four Llama-3-8B projections (nvfp4) at m = 64 through
    fused_mul(..., sid=...) with weight-cache ids 16x64 and 16x128 at their
    default splits, and the plain 16-row tile 16x64 beside them, L2-warm,
    summed over the four, and as one CUDA graph of the four (each launch
    finds its weights cold). It calls only the quantizer, the layout,
    SolutionId and fused_mul, which older trees have too. Times only: the
    kernels phase checks the bits."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    m, out, graphs = 64, {}, {}
    for k, n in LLAMA8B_KN:
        w = torch.randn((n, k), generator=gen, device="cuda") / math.sqrt(k)
        qw, sc, gs = qref.quantize_nvfp4(w)
        del w
        words = layout.repack_fp4_weights(qw, n, k)
        st = layout.process_fp4_scales(sc, n, k, group_size=16)
        a = torch.randn((m, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        for bn, wc in ((64, True), (128, True), (64, False)):
            sid = solution_mod.SolutionId(16, bn, ElementB.NVFP4,
                                          weight_cache=wc)
            key = f"m={m} tile=16x{bn}{' weight cache' if wc else ''}"
            call = (lambda a=a, w=words, s=st, g=gs.reshape(1), sid=sid:
                    fused.fused_mul(a, w, s, g, sid=sid))
            out[key] = out.get(key, 0.0) + cuda_ms(call)
            graphs.setdefault(key, []).append(call)
    for key, calls in graphs.items():
        out[f"{key} graph"] = len(calls) * _cold_ms(calls)
        log(f"[fp4_wc_layer] {key}: 4 projections {out[key]:.4f} ms warm, "
            f"{out[f'{key} graph']:.4f} ms as a CUDA graph")
    log(json.dumps({"fp4_wc_layer": out}))
    rec["fp4_wc_layer"] = out


def phase_fp4_layer(rec):
    """The FP4 GEMM's decode layer alone, for an A/B of two trees: the four
    Llama-3-8B projections (nvfp4) at m = 8 through fused_mul with its
    default tile and splits, L2-warm, L2-flushed and as one CUDA graph of
    the four (136 MB of weights: each launch finds its own cold), summed
    over the layer; and the host time of one call (wo) through the
    Engine's GEMM entry, gemm.mul_fp4_diff, and through fused_mul alone.
    It calls only the quantizer, the layout, choose_default_solution,
    fused_mul(a, words, scales, gs, sid=...), mul_fp4_diff,
    benchlib.cuda_time and torch.cuda graphs, which older trees have too,
    so a copy of this script placed in an older checkout times that tree's
    kernel."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = dict(warm_ms=0.0, flushed_ms=0.0, per_projection=[])
    calls = []
    for k, n in LLAMA8B_KN:
        w = torch.randn((n, k), generator=gen, device="cuda") / math.sqrt(k)
        qw, sc, gs = qref.quantize_nvfp4(w)
        del w
        words = layout.repack_fp4_weights(qw, n, k)
        st = layout.process_fp4_scales(sc, n, k, group_size=16)
        a = torch.randn((8, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        sid = solution_mod.choose_default_solution(8, n, k, ElementB.NVFP4)
        call = (lambda a=a, w=words, s=st, g=gs.reshape(1), sid=sid:
                fused.fused_mul(a, w, s, g, sid=sid))
        calls.append(call)
        if (k, n) == LLAMA8B_KN[1]:
            wo = (a, words, st, gs.reshape(1), sid)
        warm, flushed = cuda_ms(call), _flushed_ms(call)
        out["per_projection"].append(dict(k=k, n=n, warm_ms=warm,
                                          flushed_ms=flushed))
        out["warm_ms"] += warm
        out["flushed_ms"] += flushed
        log(f"[fp4_layer] k={k} n={n}: {warm:.4f} ms warm, {flushed:.4f} ms "
            "flushed")
    out["graph_ms"] = 4 * _cold_ms(calls)
    log(f"[fp4_layer] layer (4 projections, m=8): {out['warm_ms']:.4f} ms "
        f"warm, {out['flushed_ms']:.4f} ms flushed, {out['graph_ms']:.4f} ms "
        "graph")
    # host time a call: the wall clock of enqueueing 200 back-to-back calls
    # (the device, at about 20 us a call, keeps up), as the Engine runs them
    k, n = LLAMA8B_KN[1]
    a, words, st, gs, sid = wo
    for name, fn in (
            ("mul_fp4_diff", lambda: gemm.mul_fp4_diff("nvfp4", k, a, words,
                                                       st, gs)),
            ("fused_mul", lambda: fused.fused_mul(a, words, st, gs,
                                                  sid=sid))):
        with torch.inference_mode():
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            out[f"host_us_{name}"] = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
        log(f"[fp4_layer] host time a call, {name} (k={k} n={n} m=8): "
            f"{out[f'host_us_{name}']:.1f} us")
    log(json.dumps({"fp4_layer": out}))
    rec["fp4_layer"] = out


def phase_grouped_layer(rec):
    """The grouped GEMM's decode layer alone, for an A/B of two trees:
    _grouped_layer without checks (one Mixtral-8x7B layer's three grouped
    calls at cap 8, full buckets, and routed ones where the tree's
    grouped_mul takes `rows`). It calls only the quantizer, moe's routing
    helpers, grouped_mul(xs, words, scales, gs[, rows=...]) and
    torch.cuda graphs, so a copy of this script placed in an older
    checkout times that tree's kernel."""
    out = _grouped_layer()
    log(json.dumps({"grouped_layer": out}))
    rec["grouped_layer"] = out


def phase_append_layer(rec):
    """The KV writes alone, for an A/B of two trees, each as a CUDA graph of
    20 launches (their back-to-back launches wait on the host), ms a
    launch: kv_append into a flat bf16 cache and into headed bf16 and fp8
    caches, and kv_append_paged (where the tree has it) into an fp8 pool
    at page size 16 (B = 8, S = 2048, Hkv = 8, d = 128, the kernels phase's
    positions and int32 mask, contiguous new rows); the torch glue of the
    paged write (_paged_glue); each _write_kv as the Llama block calls it
    (K and V strided views of the fused qkv tensor, int32 positions): a
    decode step (B = 4, the engine's bool write mask) and a 256-token
    prefill chunk (B = 1, no mask), flat bf16, headed fp8 and paged fp8;
    and an empty kernel (torch.cuda._sleep(0)), the floor of one launch in
    a graph. It calls only attention.kv_append, kv_append_paged where it
    exists, llama._write_kv and paged._write_kv, so a copy of this script
    placed in an older checkout times that tree's writes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    B, Hkv, d, S, ps = 8, 8, 128, 2048, 16
    pos = torch.tensor([0, 5, 127, 128, 700, 1023, 1500, 2047],
                       dtype=torch.int32, device=dev)
    mask = torch.tensor([1, 0, 1, 1, 0, 1, 0, 1], dtype=torch.int32,
                        device=dev)
    kn, vn = (torch.randn((B, Hkv, d), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    out = {}

    def graph(name, fn):
        out[name] = _graph_ms(fn)
        log(f"[append_layer] {name}: {out[name] * 1e3:.3f} us a launch as a "
            "CUDA graph")

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for name, shape, dtype, headed in (
            ("kv_append", (B, S, Hkv, d), torch.bfloat16, False),
            ("kv_append_headed bf16", (B, Hkv, S, d), torch.bfloat16, True),
            ("kv_append_headed fp8", (B, Hkv, S, d), FP8, True)):
        ck = rand(shape, dtype)
        cv = ck.clone()
        graph(name, lambda: attention.kv_append(ck, cv, kn, vn, pos, mask,
                                               headed=headed))
    nb = S // ps
    pool = tuple(rand((B * nb + 1, Hkv, ps, d), FP8) for _ in range(2))
    bt = torch.randperm(B * nb, generator=gen, device=dev).reshape(
        B, nb).to(torch.int32)
    if hasattr(attention, "kv_append_paged"):
        graph("kv_append_paged fp8", lambda: attention.kv_append_paged(
            *pool, bt, kn, vn, pos, ps, mask))
    graph("paged glue fp8", lambda: _paged_glue(
        pool, bt, kn[:, None], vn[:, None], pos[:, None], ps, mask))
    # _write_kv as the Llama block calls it
    for T, rows, wmask in ((1, 4, torch.tensor([True, True, False, True],
                                               device=dev)),
                           (256, 1, None)):
        _, k, v = _fused_kv(gen, rows, T)
        wpos = (pos[:rows, None] + torch.arange(
            T, device=dev, dtype=torch.int32)).clamp(max=S - 1)
        ck = rand((rows, S, Hkv, d), torch.bfloat16)
        cv = ck.clone()
        graph(f"_write_kv flat bf16 T={T}", lambda: llama._write_kv(
            ck, cv, k, v, wpos, wmask, False))
        hk = rand((rows, Hkv, S, d), FP8)
        hv = hk.clone()
        graph(f"_write_kv headed fp8 T={T}", lambda: llama._write_kv(
            hk, hv, k, v, wpos, wmask, True))
        graph(f"_write_kv paged fp8 T={T}", lambda: paged._write_kv(
            pool, bt[:rows], k, v, wpos, ps, wmask))
    graph("empty kernel", lambda: torch.cuda._sleep(0))
    rec["append_layer"] = out


# decode attention's A/B shapes (H = 32, Hkv = 8, d = 128): the Engine's
# decode step, 4 slots mid-decode (the serve phase's prompts of 258, 300,
# 161 and 92 tokens 16 steps in, window 512), and the kernels phase's 8
# ragged sequences over 2048 positions
DECODE_LAYER_SHAPES = (("engine B=4 window=512", (274, 316, 177, 108), 512),
                       ("kernels B=8 window=2048",
                        (0, 5, 127, 128, 700, 1023, 1500, 2047), 2048))


def phase_decode_attn_layer(rec):
    """Decode attention alone, for an A/B of two trees: at each of
    DECODE_LAYER_SHAPES, flat bf16, headed fp8 and paged fp8 (page size 16)
    decode attention, each as a CUDA graph of 32 launches, one a layer over
    the layer's own cache (so each launch finds its K/V cold, as a decode
    step does), beside scaled_dot_product_attention over the same bf16 K/V
    ((B, Hkv, S, d) contiguous, boolean position mask) as a graph of 32.
    Times are device us a launch and ms the 32; bound: the bytes of the
    positions attended (_decode_work). It calls only the public wrappers
    with the arguments every tree's take, so a copy of this script placed
    in an older checkout times that tree's kernels."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    H, Hkv, d, layers, ps = 32, 8, 128, 32, 16
    out = {}
    for shape, pos_l, window in DECODE_LAYER_SHAPES:
        B = len(pos_l)
        pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
        q = torch.randn((B, H, d), generator=gen, device=dev).to(
            torch.bfloat16)
        nb = window // ps
        mask = _decode_mask(pos, window, window)
        calls = {"flat bf16": [], "headed fp8": [], "paged fp8 ps=16": [],
                 "sdpa bf16": []}
        for _ in range(layers):
            k, v = (torch.randn((B, window, Hkv, d), generator=gen,
                                device=dev).to(torch.bfloat16)
                    for _ in range(2))
            kh, vh = k.transpose(1, 2).contiguous(), v.transpose(
                1, 2).contiguous()
            k8, v8 = kh.to(FP8), vh.to(FP8)
            bt = torch.randperm(B * nb, generator=gen, device=dev).reshape(
                B, nb).to(torch.int32)
            kp, vp = (torch.randn((B * nb + 1, Hkv, ps, d), generator=gen,
                                  device=dev).to(FP8) for _ in range(2))
            calls["flat bf16"].append(
                lambda k=k, v=v: attention.decode_attention_contiguous(
                    q, k, v, pos, nb=nb, page_size=ps))
            calls["headed fp8"].append(
                lambda k=k8, v=v8: attention.decode_attention_contiguous_headed(
                    q, k, v, pos, nb=nb, page_size=ps))
            calls["paged fp8 ps=16"].append(
                lambda k=kp, v=vp, t=bt: attention.paged_decode_attention(
                    q, k, v, t, pos, nb=nb, page_size=ps))
            calls["sdpa bf16"].append(
                lambda k=kh, v=vh: _sdpa(q[:, :, None], k, v, mask))
            del k, v
        row = {}
        for name, cs in calls.items():
            t = _cold_ms(cs, reps=layers)
            elt = 1 if "fp8" in name else 2
            b = bound(*_decode_work(q, pos, Hkv, elt,
                                    page_size=ps if "paged" in name else None))
            row[name] = dict(us_a_launch=t * 1e3, ms_32=t * layers, **b)
            log(f"[decode_attn_layer] {shape} {name}: {t * 1e3:.3f} us a "
                f"launch, {t * layers:.4f} ms the 32 (graph); bound "
                f"{b['bound_ms'] * 1e3:.3f} us")
        out[shape] = row
        del calls
        gc.collect()
        torch.cuda.empty_cache()
    rec["decode_attn_layer"] = out


def phase_hp_layer(rec):
    """The high-precision GEMM's tiles alone, for an A/B of two trees or of
    copies of csrc/fp4_stream.cuh's f32 form or csrc/fp4_hp_wgmma.cuh
    edited to find what bounds them: the four Llama-3-8B projections
    (nvfp4, f32 A) through fused_mul(..., sid=...) with hp ids at their
    default splits, m = 8 at 16x64 and 16x128, the weight cache at m = 64
    (16x64), and the 64-row tiles at m = 2048 (64x128 and 64x64, plain
    and weight cache), L2-warm and L2-flushed, summed over the four, and as
    one CUDA graph of the four (each launch finds its weights cold), beside
    f32 torch.matmul (TF32 off) at m = 8, 64 and 2048 on the dequantized
    weights, warm and as a graph. It calls only the quantizer, the layout,
    SolutionId, fused_mul and benchlib.cuda_time, which older trees have
    too, so a copy of this script placed in an older checkout times that
    tree's kernel. Times only: the solutions phase checks the results."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    # (key, m, block_m, block_n, weight cache)
    runs = (("m=8 tile=16x64", 8, 16, 64, False),
            ("m=8 tile=16x128", 8, 16, 128, False),
            ("m=64 tile=16x64 weight cache", 64, 16, 64, True),
            ("m=2048 tile=64x128", 2048, 64, 128, False),
            ("m=2048 tile=64x128 weight cache", 2048, 64, 128, True),
            ("m=2048 tile=64x64", 2048, 64, 64, False),
            ("m=2048 tile=64x64 weight cache", 2048, 64, 64, True))
    out, graphs = {}, {}
    for k, n in LLAMA8B_KN:
        w = torch.randn((n, k), generator=gen, device="cuda") / math.sqrt(k)
        qw, sc, gs = qref.quantize_nvfp4(w)
        del w
        words = layout.repack_fp4_weights(qw, n, k)
        st = layout.process_fp4_scales(sc, n, k, group_size=16)
        gs = gs.reshape(1)
        deq = layout.dequant_from_tpu_layout(words, st, n, k)
        acts = {m: torch.randn((m, k), generator=gen, device="cuda")
                for m in (8, 64, 2048)}
        for key, m, bm, bn, wc in runs:
            sid = solution_mod.SolutionId(bm, bn, ElementB.NVFP4,
                                          high_precision=True,
                                          weight_cache=wc)
            call = (lambda a=acts[m], w=words, s=st, g=gs, sid=sid:
                    fused.fused_mul(a, w, s, g, sid=sid))
            out[key] = out.get(key, 0.0) + cuda_ms(call)
            out[f"{key} flushed"] = (out.get(f"{key} flushed", 0.0)
                                     + _flushed_ms(call))
            graphs.setdefault(key, []).append(call)
        for m in (8, 64, 2048):
            key = f"m={m} matmul f32"
            call = (lambda a=acts[m], d=deq: torch.matmul(a, d))
            out[key] = out.get(key, 0.0) + cuda_ms(call)
            graphs.setdefault(key, []).append(call)
    for key, calls in graphs.items():
        out[f"{key} graph"] = len(calls) * _cold_ms(calls)
        log(f"[hp_layer] {key}: 4 projections {out[key]:.4f} ms warm, "
            + (f"{out[f'{key} flushed']:.4f} ms flushed, "
               if f"{key} flushed" in out else "")
            + f"{out[f'{key} graph']:.4f} ms as a CUDA graph")
    log(json.dumps({"hp_layer": out}))
    rec["hp_layer"] = out


def _quantized_weight(fmt, k, n, gen):
    """A random (n, k) weight quantized with `fmt` on the card: (words,
    scales, gs (1,), element_b, the f32 dequantized (k, n) without gs)."""
    quant, group = ((qref.quantize_nvfp4, 16) if fmt == "nvfp4"
                    else (qref.quantize_mxfp4, 32))
    w = torch.randn((n, k), generator=gen, device="cuda") / math.sqrt(k)
    qw, sc, gs = quant(w)
    del w
    words = layout.repack_fp4_weights(qw, n, k,
                                      pad_to=layout.pad_multiple(group))
    st = layout.process_fp4_scales(sc, n, k, group_size=group)
    eb = ElementB.NVFP4 if fmt == "nvfp4" else ElementB.MXFP4
    return (words, st, gs.reshape(1), eb,
            layout.dequant_from_tpu_layout(words, st, n, k))


def _hp_rule(a, deq, gs, got, plain):
    """The high-precision acceptance rule against the f64 product of the
    same operands: max|got - f64| <= 4 max|plain - f64| + 2^-24 max(|A| @
    |B|) |gs|, plain being the f32 library product (the plain version,
    TF32 off). Returns (|got - f64|, |plain - f64|, the bound)."""
    a64, b64, g64 = a.double(), deq.double(), gs.double()
    exact = (a64 @ b64) * g64
    scale = ((a64.abs() @ b64.abs()) * g64.abs()).max().item()
    e_got = (got.double() - exact).abs().max().item()
    e_lib = (plain.double() - exact).abs().max().item()
    return e_got, e_lib, 4 * e_lib + 2 ** -24 * scale


def _hp_kernels(res, rows, gen):
    """(a) fp4_gemm_hp at the four Llama-3-8B projections, m = 8, nvfp4,
    tile 16x64 with f32 activations and with bf16 ones (their f32 values),
    16x128 with f32 ones, and mxfp4 on wqkv, and at m = 2048 (the default
    tile, 64x128); fp4_gemm_hp_wc's 16-row tiles at m = 64 (16x64) and its
    64-row ones at m = 2048 (the default tile), each bit for bit
    fp4_gemm_hp at the same tile and split count. Every 16-row launch is
    counted as a launch of the stream kernel (fp4_hp_stream_kernel:
    .stream_launches), every 64-row one as a launch of the register-A
    wgmma body (fp4_hp_wgmma_kernel: .wgmma_launches). Each within _hp_rule of the
    f64 product; the bf16 path's distance from it beside (fp4_gemm on
    bf16(A)). Times: the kernel, its plain version and the library call
    torch.matmul on the f32 operands (TF32 off), back to back (cuda_ms,
    L2-warm), the kernel and library again with L2 flushed
    (benchlib.cuda_time), and, summed over the four projections at m = 8
    and 64, as one CUDA graph of the four launches (each finds its weights
    cold). Bound: the larger of the bytes at 3.35 TB/s and 3 * 2mnk at the
    bf16 peak: three bf16 passes are the least the card needs for an
    f32-accurate product over bf16-exact weights. The JSON rows: nvfp4 f32
    m = 8 (16x64; the 16x128 times beside), m = 64 weight cache, m = 2048
    plain (fp4_gemm_hp_prefill) and weight cache (fp4_gemm_hp_wc, and
    fp4_gemm_hp_wc_prefill for its 64-row tiles), each summed over the four
    projections."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the f32 yardstick would "
                             "keep 10 mantissa bits")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # (m, block_n: None for the default tile, weight cache) -> row
    names = {(8, 64, False): "fp4_gemm_hp", (8, 128, False):
             "fp4_gemm_hp 16x128", (64, 64, True): "fp4_gemm_hp_wc_16row",
             (2048, None, False): "fp4_gemm_hp_prefill",
             (2048, None, True): "fp4_gemm_hp_wc"}
    sums = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flushed_ms=0.0,
                       library_flushed_ms=0.0, nbytes=0, flops=0, err=0.0,
                       calls=[], library_calls=[], splits=[])
            for name in names.values()}
    m_of = {name: m for (m, _, _), name in names.items()}
    # (fmt, (k, n), m, block_n, weight cache)
    cases = ([("nvfp4", kn, m, bn, wc) for m, bn, wc in names
              for kn in LLAMA8B_KN]
             + [("mxfp4", LLAMA8B_KN[0], 8, 64, False)])
    weights = {}
    for fmt, (k, n), m, bn, wc in cases:
        if (fmt, k, n) not in weights:
            weights[(fmt, k, n)] = _quantized_weight(fmt, k, n, gen)
        words, st, gs, eb, deq = weights[(fmt, k, n)]
        kp = words.shape[0] * 8
        a32 = torch.randn((m, k), generator=gen, device=dev)
        plain_sid = (solution_mod.choose_default_solution(
            m, n, k, eb, high_precision=True) if bn is None else
            solution_mod.SolutionId(16, bn, eb, high_precision=True))
        sid = dataclasses.replace(plain_sid, weight_cache=wc)
        splits = fused.hp_splits(m, n, kp, sid, sms)
        name = names[(m, bn, wc)]
        kernel = fused.fused_mul_hp_wc if wc else fused.fused_mul_hp
        inputs = [("f32", a32)]
        if fmt == "nvfp4" and (m, bn) == (8, 64):
            inputs.append(("bf16", a32.to(torch.bfloat16).float()))
        for a_kind, a in inputs:
            stream, wgmma = kernel.stream_launches, kernel.wgmma_launches
            got = kernel(a, words, st, gs, sid=sid)
            if (kernel.stream_launches, kernel.wgmma_launches) != (
                    stream + (sid.block_m == 16), wgmma + (sid.block_m == 64)):
                raise AssertionError(f"{name} k={k} n={n}: the launch missed "
                                     "its tile body (stream or wgmma)")
            plain = fused.fused_mul_hp_reference(a, words, st, gs, sid=sid)
            bf16_path = fused.fused_mul(
                a.to(torch.bfloat16), words, st, gs,
                sid=solution_mod.choose_default_solution(m, n, k, eb))
            torch.cuda.synchronize()
            what = (f"hp {fmt} {a_kind} A m={m} k={k} n={n} "
                    f"tile={sid.block_m}x{sid.block_n} splits={splits}")
            e_hp, e_lib, lim = _hp_rule(a, deq, gs, got, plain)
            e_bf16 = _hp_rule(a, deq, gs, bf16_path, plain)[0]
            if not torch.isfinite(got).all() or not e_hp <= lim:
                raise AssertionError(f"{what}: max|hp - f64| {e_hp:.3e} > "
                                     f"{lim:.3e} (f32 library {e_lib:.3e})")
            again = kernel(a, words, st, gs, sid=sid)
            if not torch.equal(again.view(torch.int32), got.view(torch.int32)):
                raise AssertionError(f"{what}: a second launch differs")
            if wc:
                one = fused.fused_mul_hp(a, words, st, gs, sid=plain_sid,
                                         splits=splits)
                if not torch.equal(one.view(torch.int32),
                                   got.view(torch.int32)):
                    raise AssertionError(f"{what}: weight cache differs from "
                                         "fp4_gemm_hp bit for bit")
                del one
            if a_kind == "bf16":
                pub = gemm.mul_nvfp4_a16(
                    a.to(torch.bfloat16), words, st, gs, m, n, k,
                    hints=solution_mod.SolutionHints(
                        b_type=eb, require_high_precision=True))
                if not torch.equal(pub.view(torch.int16), got.to(
                        torch.bfloat16).view(torch.int16)):
                    raise AssertionError(f"{what}: the public entry is not "
                                         "bf16(fp4_gemm_hp)")
            e_twin = (got - plain).abs().max().item()
            iters = 5 if m == 2048 else 20
            call = (lambda a=a, w=words, s_=st, g=gs, sid=sid:
                    kernel(a, w, s_, g, sid=sid))
            lib = (lambda a=a, d=deq: torch.matmul(a, d))
            t_k = cuda_ms(call, iters=iters)
            t_p = cuda_ms(lambda: fused.fused_mul_hp_reference(
                a, words, st, gs, sid=sid), iters=iters)
            t_l = cuda_ms(lib, iters=iters)
            t_kf = benchlib.cuda_time(call, iters=iters) * 1e3
            t_lf = benchlib.cuda_time(lib, iters=iters) * 1e3
            nbytes = _nbytes(a, words, st, gs, got)
            flops = 2 * m * n * k
            row = dict(kernel=name, fmt=fmt, a=a_kind, m=m, k=k, n=n,
                       tile=[sid.block_m, sid.block_n], splits=splits,
                       weight_cache=wc, err_vs_f64=e_hp,
                       f32_library_err_vs_f64=e_lib, bf16_path_err_vs_f64=
                       e_bf16, limit=lim, max_abs_err=e_twin, ms=t_k,
                       plain_ms=t_p, library_ms=t_l, flushed_ms=t_kf,
                       library_flushed_ms=t_lf,
                       **bound(nbytes, 3 * flops))
            rows.append(row)
            log(f"[solutions] {what}{' wc' if wc else ''}: |hp-f64| "
                f"{e_hp:.3e}, |f32 matmul-f64| {e_lib:.3e}, |bf16 path-f64| "
                f"{e_bf16:.3e} (limit {lim:.3e}); kernel={t_k:.4f} ms "
                f"({t_kf:.4f} flushed) plain={t_p:.4f} ms matmul "
                f"f32={t_l:.4f} ms ({t_lf:.4f} flushed) "
                f"bound={row['bound_ms']:.4f} ms ({row['bound_by']})")
            acc = sums[name]
            acc["err"] = max(acc["err"], e_twin)
            if fmt == "nvfp4" and a_kind == "f32":
                for key, v in (("ms", t_k), ("plain_ms", t_p),
                               ("library_ms", t_l), ("flushed_ms", t_kf),
                               ("library_flushed_ms", t_lf),
                               ("nbytes", nbytes), ("flops", 3 * flops)):
                    acc[key] += v
                acc["calls"].append(call)
                acc["library_calls"].append(lib)
                acc["splits"].append(splits)
            del got, plain, bf16_path, again
    for name, acc in sums.items():
        if m_of[name] < 2048:   # 16-row tiles: the four as graphs
            acc["graph_ms"] = len(acc["calls"]) * _cold_ms(acc["calls"])
            acc["library_graph_ms"] = len(acc["library_calls"]) * _cold_ms(
                acc["library_calls"])
            log(f"[solutions] {name} (nvfp4 f32 A, 4 projections, splits "
                f"{acc['splits']}): {acc['ms']:.4f} ms warm, "
                f"{acc['flushed_ms']:.4f} flushed, {acc['graph_ms']:.4f} "
                f"graph; matmul f32 {acc['library_ms']:.4f} warm, "
                f"{acc['library_flushed_ms']:.4f} flushed, "
                f"{acc['library_graph_ms']:.4f} graph; bound "
                f"{bound(acc['nbytes'], acc['flops'])['bound_ms']:.4f} ms")
        acc.pop("calls")
        acc.pop("library_calls")
    weights.clear()
    wide = sums.pop("fp4_gemm_hp 16x128")
    for name, m in (("fp4_gemm_hp", 8), ("fp4_gemm_hp_wc_16row", 64),
                    ("fp4_gemm_hp_prefill", 2048), ("fp4_gemm_hp_wc", 2048)):
        acc = sums[name]
        extra = {k: acc[k] for k in ("flushed_ms", "library_flushed_ms",
                                     "graph_ms", "library_graph_ms",
                                     "splits") if k in acc}
        if name == "fp4_gemm_hp":
            extra.update({f"{k}_16x128": wide[k] for k in (
                "ms", "flushed_ms", "graph_ms", "splits")})
        tile = {"fp4_gemm_hp": "tile 16x64 (16x128: the _16x128 keys)",
                "fp4_gemm_hp_wc_16row": "weight cache, tile 16x64, 2 "
                "m-tiles a CTA, bit-equal to fp4_gemm_hp at the same splits",
                "fp4_gemm_hp_prefill": "the default tile, 64x128, the "
                "register-A wgmma body",
                "fp4_gemm_hp_wc": "weight cache, the default tile, 2 m-tiles "
                "a CTA, bit-equal to fp4_gemm_hp_prefill"}[name]
        res[name] = dict(
            max_abs_err=acc["err"], ms=acc["ms"], plain_ms=acc["plain_ms"],
            library_ms=acc["library_ms"], **extra,
            **bound(acc["nbytes"], acc["flops"]),
            at=f"nvfp4 f32 A m={m}, sum of the 4 Llama-3-8B projections, "
               f"{tile}, default splits; error against the plain version "
               "(f32 torch.matmul, TF32 off); ms back to back, flushed_ms "
               "L2 flushed, graph_ms a CUDA graph of the four; library: "
               "torch.matmul on the f32 dequantized weights; bound at 3 "
               "bf16 passes")
    # the weight cache's 64-row tiles: fp4_gemm_hp_wc's row at m = 2048
    res["fp4_gemm_hp_wc_prefill"] = dict(res["fp4_gemm_hp_wc"])


_SWEEP_SHAPES = ((8, 4096, 4096), (100, 6144, 4096), (2048, 4096, 14336))


def _solution_sweep(rec, gen):
    """(b) Every id get_fp4_solutions lists, nvfp4 and mxfp4, at
    _SWEEP_SHAPES, through mul_nvfp4_a16 / mul_mxfp4_a16 with the explicit
    id on f32 activations: the launch counts are set to 0 just before and
    read just after; then each output against its plain version, at the
    GEMM tolerance for bf16 ids and _hp_rule for hp ids."""
    jobs = []
    for fmt in ("nvfp4", "mxfp4"):
        for m, n, k in _SWEEP_SHAPES:
            words, st, gs, eb, deq = _quantized_weight(fmt, k, n, gen)
            a = torch.randn((m, k), generator=gen, device="cuda")
            ids = gemm.get_fp4_solutions(m, n, k, element_b=eb)
            jobs.append((fmt, m, n, k, words, st, gs, eb, deq, a, ids))
    torch.cuda.synchronize()
    _reset_launches()
    outs = []
    for fmt, m, n, k, words, st, gs, eb, deq, a, ids in jobs:
        mul = gemm.mul_nvfp4_a16 if fmt == "nvfp4" else gemm.mul_mxfp4_a16
        outs.append([mul(a, words, st, gs, m, n, k, r) for r in ids])
    torch.cuda.synchronize()
    launches = _launch_counts()
    path = "solutions sweep"
    missing = [name for name in PATHS[path] if launches[name] == 0]
    n_ids = sum(len(job[-1]) for job in jobs)
    if missing or _calls(launches) != n_ids:
        raise AssertionError(f"{path}: {n_ids} ids, launches {launches}; "
                             f"never launched: {missing}")
    for name, n_ in launches.items():
        rec["launches"][name] = rec["launches"].get(name, 0) + n_
    log(json.dumps({"path": path, "launches": launches}))
    worst = {}
    for job, got_all in zip(jobs, outs):
        fmt, m, n, k, words, st, gs, eb, deq, a, ids = job
        plain16 = fused.fused_mul_reference(a, words, st, gs, sid=None)
        plain32 = fused.fused_mul_hp_reference(a, words, st, gs, sid=None)
        for r, got in zip(ids, got_all):
            sid = solution_mod.SolutionId.from_repr(r)
            what = f"sweep {fmt} m={m} k={k} n={n} {sid}"
            if sid.high_precision:
                e, _, lim = _hp_rule(a, deq, gs, got, plain32)
                if not e <= lim:
                    raise AssertionError(f"{what}: |hp - f64| {e} > {lim}")
            else:
                e = _close(what, got, plain16, 2 ** -7,
                           2 ** -8 * plain16.float().abs().max())
            kind = ("hp " if sid.high_precision else "") + (
                "wc" if sid.weight_cache else "plain")
            worst[kind] = max(worst.get(kind, 0.0), e)
        log(f"[solutions] sweep {fmt} m={m} k={k} n={n}: {len(ids)} ids "
            f"launched and match their plain versions")
        del plain16, plain32
    jobs.clear()
    outs.clear()
    return dict(ids=n_ids, launches=launches, max_err=worst)


def _tuner_run():
    """(c) tune_suite over the four Llama-3-8B projections at m = 16 and
    2048, nvfp4, not saved: every candidate timed (benchlib.cuda_time)."""
    shapes = [(m, n, k) for m in (16, 2048) for k, n in LLAMA8B_KN]
    gemm.set_tuned_table({})
    t0 = time.perf_counter()
    table = autotune.tune_suite(shapes, ElementB.NVFP4, verbose=True,
                                save=False)
    best = {}
    for m, n, k in shapes:
        sid = solution_mod.SolutionId.from_repr(table[gemm._table_key(
            m, n, k, ElementB.NVFP4, solution_mod.MatmulType.BF16, False)])
        best[f"{m},{n},{k}"] = [sid.block_m, sid.block_n, sid.weight_cache]
        log(f"[solutions] tuner m={m} n={n} k={k}: {sid.block_m}x"
            f"{sid.block_n}{' wc' if sid.weight_cache else ''}")
    return dict(seconds=time.perf_counter() - t0, best=best)


H100_TABLE = "NVIDIA_H100_80GB_HBM3"


def _tuned_table_check(rec, gen):
    """(c) Every entry of the committed H100 table (ops/autotune.py
    load_table): its id is feasible at its key, and launches once there
    through the public entry with the explicit id (mul_*_a16, mul_*_a8 for
    INT8 keys, grouped_mul for grouped ones), with the launch counts set to
    0 just before and read just after; every output finite."""
    if not autotune.load_table(H100_TABLE):
        raise AssertionError(f"no committed table "
                             f"{autotune.table_path(H100_TABLE)}")
    table = dict(gemm._TUNED_TABLE)
    by_weight = {}
    for key, r in sorted(table.items()):
        m, n, k, eb, mt, hp, is_grouped = key
        sid = solution_mod.SolutionId.from_repr(r)
        if not solution_mod.is_feasible(sid, m, n, k):
            raise AssertionError(f"table entry {key}: {sid} infeasible")
        by_weight.setdefault((n, k, eb, is_grouped), []).append((key, sid))
    _reset_launches()
    n_calls = 0
    for (n, k, eb, is_grouped), entries in by_weight.items():
        E = 2 if is_grouped else 1
        w, s, _ = autotune.random_weight(
            "nvfp4" if eb == ElementB.NVFP4 else "mxfp4", n, k, gen)
        words = w.expand(E, *w.shape).contiguous()
        st = s.expand(E, *s.shape).contiguous()
        del w, s
        gs = torch.ones((E,), device="cuda")
        for key, sid in entries:
            m = key[0]
            a = torch.randn((E, m, k), generator=gen, device="cuda")
            before = _calls(_launch_counts())
            if is_grouped:
                y = grouped.grouped_mul(a.to(torch.bfloat16), words, st, gs,
                                        sid=sid)
            elif sid.mfma_type == solution_mod.MatmulType.INT8:
                mul = (gemm.mul_nvfp4_a8 if eb == ElementB.NVFP4
                       else gemm.mul_mxfp4_a8)
                y = mul(a[0], words[0], st[0], gs, m, n, k, sid.repr())
            else:
                mul = (gemm.mul_nvfp4_a16 if eb == ElementB.NVFP4
                       else gemm.mul_mxfp4_a16)
                y = mul(a[0] if sid.high_precision else a[0].to(
                    torch.bfloat16), words[0], st[0], gs, m, n, k, sid.repr())
            if _calls(_launch_counts()) != before + 1:
                raise AssertionError(f"table entry {key}: {sid} did not "
                                     "launch once")
            if not torch.isfinite(y).all():
                raise AssertionError(f"table entry {key}: non-finite output")
            n_calls += 1
        del words, st
    torch.cuda.synchronize()
    launches = _launch_counts()
    for name, n_ in launches.items():
        rec["launches"][name] = rec["launches"].get(name, 0) + n_
    log(json.dumps({"path": "solutions tuned table", "entries": n_calls,
                    "launches": launches}))
    return dict(entries=n_calls, launches=launches)


def _bench_modes():
    """(e) The other modes of the tune and bench entry points, each once on
    a short run: tune_grouped_shape at one Mixtral expert shape (E = 8, cap
    64, w_gate (n, k) = (14336, 4096), mxfp4); the port bench's --format
    mxfp4, mxfp4z, w4a8 and hybrid on the quick suite, --trace, --shard70b
    and --tune, at 2 timed calls a case; the bench CLI at one shape. Every
    bench line's value and vs_baseline must be finite and positive, and the
    CLI must print one row with positive times."""
    t0 = time.perf_counter()
    out = {}
    sid = autotune.tune_grouped_shape(8, 64, 14336, 4096, ElementB.MXFP4,
                                      verbose=True)
    if sid is None or sid.weight_cache:
        raise AssertionError(f"tune_grouped_shape picked {sid}")
    out["tune_grouped"] = [sid.block_m, sid.block_n]
    log(f"[solutions] tune_grouped_shape E=8 cap=64 n=14336 k=4096: "
        f"{sid.block_m}x{sid.block_n}")
    for args in (["--format", "mxfp4"], ["--format", "mxfp4z"],
                 ["--format", "w4a8"], ["--format", "hybrid"], ["--trace"],
                 ["--shard70b"], ["--tune"]):
        with contextlib.redirect_stdout(io.StringIO()):
            line = port_bench.main(args + ["--iters", "2"])
        if not all(math.isfinite(line[key]) and line[key] > 0
                   for key in ("value", "vs_baseline")):
            raise AssertionError(f"bench {args}: {line}")
        out[" ".join(args)] = line
        log(f"[solutions] bench {' '.join(args)}: {json.dumps(line)}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        port_cli.bench_main(["--shapes", "4096,4096", "--ms", "16",
                             "--iters", "5"])
    rows = buf.getvalue().splitlines()
    times = [float(x) for x in re.findall(r"([0-9.]+) us", rows[0])
             ] if rows else []
    if len(rows) != 1 or len(times) != 2 or min(times) <= 0:
        raise AssertionError(f"bench CLI printed {rows}")
    out["bench_cli"] = rows[0]
    log(f"[solutions] bench CLI: {rows[0]}")
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_solutions(rec):
    """The GEMM API's solution layer (phase 4 above). The tuned table is
    restored to what it was (empty) afterwards: the engines of the later
    phases dispatch through the heuristic, as before."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    res = rec.setdefault("kernels", {})
    rec.setdefault("launches", {})
    rows = rec.setdefault("kernel_rows", [])
    out = {}
    _hp_kernels(res, rows, gen)
    out["sweep"] = _solution_sweep(rec, gen)
    saved = dict(gemm._TUNED_TABLE)
    try:
        out["tuner"] = _tuner_run()
        out["table"] = _tuned_table_check(rec, gen)
        with contextlib.redirect_stdout(io.StringIO()):
            out["bench"] = port_bench.main([])
        log(f"[solutions] bench: {json.dumps(out['bench'])}")
        out["modes"] = _bench_modes()
    finally:
        gemm.set_tuned_table(saved)
    rec["solutions"] = out


def _random_quantized(cfg, gen):
    """Random nvfp4 params on the generator's device."""
    return llama.quantize_params(llama.init_params(cfg, gen), "nvfp4")


def _check_score(name, got, want, out):
    """An engine's score_forward on the card (its flash prefill kernel)
    against the CPU's prefill logits of the same chunk: within 2^-5 *
    max|logits| (row by row, so a long chunk's f32 copies stay small)."""
    bound_ = 2 ** -5 * max(w.float().abs().max().item() for w in want)
    err = max((g.float().cpu() - w.float()).abs().max().item()
              for g, w in zip(got, want))
    log(f"[parity] {name} score_forward logits max abs err {err:.4e} "
        f"(bound {bound_:.4e})")
    if not math.isfinite(err) or err > bound_:
        raise AssertionError(f"parity {name} score_forward: {err} > "
                             f"{bound_}")
    out[f"{name} score_forward"] = err


def phase_parity(rec):
    """2 layers at full Llama-3-8B width: card (kernels) vs CPU (twins),
    over the flat bf16 cache and over an fp8 page pool of page size 16;
    then the score_forward of an Engine and of an fp8 PagedEngine on the
    card against the CPU prefill chunk (at T = 64 the same computation: a
    zeroed cache, positions arange(64), window 128)."""
    dev = torch.device("cuda")
    cfg = llama.LlamaConfig.llama3_8b(num_layers=2)
    gen = torch.Generator(device=dev).manual_seed(2)
    params = _random_quantized(cfg, gen)
    cpu_params = _tree_to(params, "cpu")
    rng = np.random.default_rng(2)
    T = 64
    toks = rng.integers(0, cfg.vocab_size, size=(1, T)).astype(np.int64)
    nxt = rng.integers(0, cfg.vocab_size, size=(1, 1)).astype(np.int64)

    def flat(p, d):
        cache = llama.init_cache(cfg, 1, device=d)
        pos = torch.arange(T, device=d)[None]
        lg1, cache = llama.forward(p, torch.as_tensor(toks, device=d), cfg,
                                   cache, pos, kv_window=128)
        lg2, _ = llama.forward(p, torch.as_tensor(nxt, device=d), cfg, cache,
                               torch.full((1, 1), T, device=d), kv_window=128)
        return lg1, lg2

    def paged_fp8(p, d):
        pc = paged.init_paged_cache(cfg, 1, page_size=16, dtype=FP8, device=d)
        paged.ensure_capacity(pc, 0, T + 1)
        run = lambda tk, pos: paged.forward_paged(
            p, torch.as_tensor(tk, device=d), cfg, pc.pages, pc.block_tables,
            pos, page_size=16, kv_window=128)[0]
        return (run(toks, torch.arange(T, device=d)[None]),
                run(nxt, torch.full((1, 1), T, device=d)))

    engines = {"flat bf16": lambda: serving.Engine(params, cfg, max_batch=1),
               "paged fp8 ps=16": lambda: serving.PagedEngine(
                   params, cfg, max_batch=1, page_size=16, cache_dtype=FP8)}
    out = {}
    for cache_name, fn in (("flat bf16", flat), ("paged fp8 ps=16", paged_fp8)):
        got, want = (tuple(x.float().cpu() for x in fn(p, d))
                     for p, d in ((params, dev),
                                  (cpu_params, torch.device("cpu"))))
        eng = engines[cache_name]()
        _check_score(f"{cache_name} {type(eng).__name__}",
                     eng.score_forward(toks), want[0], out)
        del eng
        for step, g, w in zip(("prefill", "decode"), got, want):
            bound = 2 ** -5 * w.abs().max().item()
            err = (g - w).abs().max().item()
            log(f"[parity] {cache_name} {step} logits max abs err "
                f"{err:.4e} (bound {bound:.4e})")
            if not math.isfinite(err) or err > bound:
                raise AssertionError(f"parity {cache_name} {step}: {err} > "
                                     f"{bound}")
            out[f"{cache_name} {step}"] = err
    out.update(_long_score_parity(cfg, params, cpu_params))
    out.update(_w4a8_parity(cfg, params, cpu_params, rng))
    del params, cpu_params
    out.update(_hybrid_parity(cfg))
    out.update(_grad_parity())
    out.update(_moe_parity())
    rec["parity"] = out


def _long_score_parity(cfg, params, cpu_params, L=2047, B=4):
    """score_forward at the length eval gives it near max_seq_len: L =
    2047 (no multiple of 16; window 2048) with max_batch 4, so flash
    prefill runs at T = L over the whole window and the 64-row FP4 GEMM at
    m = B * L = 8188. The flat bf16 Engine, the headed fp8 Engine and the
    fp8 PagedEngine (page size 16) on the card against the CPU's chunk of
    the same KV dtype, within 2^-5 * max|logits|: the flat bf16 Engine's
    for bf16, the headed fp8 Engine's for both fp8 engines (a page pool
    holds the same fp8 K and V; a CPU chunk of this size takes about 80 s
    on 8 host cores, most of it the bf16 lm_head)."""
    engines = {
        "flat bf16 Engine": ("bf16", lambda p: serving.Engine(
            p, cfg, max_batch=B)),
        "headed fp8 Engine": ("fp8", lambda p: serving.Engine(
            p, cfg, max_batch=B, cache_dtype=FP8)),
        "paged fp8 ps=16 PagedEngine": ("fp8", lambda p: serving.PagedEngine(
            p, cfg, max_batch=B, page_size=16, cache_dtype=FP8))}
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(B, L)).astype(np.int64)
    want, out = {}, {}
    for name, (dtype, make) in engines.items():
        got = make(params).score_forward(toks)
        if got.shape != (B, L, cfg.vocab_size):
            raise AssertionError(f"parity {name} L={L}: logits "
                                 f"{tuple(got.shape)}")
        if dtype not in want:
            t0 = time.perf_counter()
            want[dtype] = make(cpu_params).score_forward(toks)
            log(f"[parity] {name} L={L} B={B}: the CPU's chunk took "
                f"{time.perf_counter() - t0:.1f} s")
        _check_score(f"{name} L={L} B={B}", got, want[dtype], out)
        del got
    return out


def _w4a8_parity(cfg, params, cpu_params, rng):
    """One 256-token prefill chunk with fmt="w4a8" (m = 256 rows take the
    W4A8 GEMM, 4 launches a layer) on the card and on the CPU. Each W4A8
    GEMM equals its twin bit for bit on equal inputs (phase kernels), but
    the card's attention and elementwise ops round differently from the
    CPU's, and rounding activations to int8 turns those ulp-level input
    differences into whole int8 steps, so the W4A8 forwards stray further
    apart than the nvfp4 ones (PERF.md). The logits must agree within the
    larger of 2^-5 * max|logits| and W4A8's own distance from the exact
    nvfp4 forward on the CPU: the card may not add more than the
    quantization itself does."""
    T = 256
    toks = rng.integers(0, cfg.vocab_size, size=(1, T)).astype(np.int64)

    def run(p, d, fmt):
        cache = llama.init_cache(cfg, 1, device=d)
        lg, _ = llama.forward(p, torch.as_tensor(toks, device=d), cfg, cache,
                              torch.arange(T, device=d)[None], fmt=fmt,
                              kv_window=T)
        return lg.float().cpu()

    before = fused.fused_mul_w4a8.launches
    got = run(params, torch.device("cuda"), "w4a8")
    n = fused.fused_mul_w4a8.launches - before
    if n != 4 * cfg.num_layers:
        raise AssertionError(f"parity w4a8: {n} W4A8 launches, expected "
                             f"{4 * cfg.num_layers}")
    want = run(cpu_params, torch.device("cpu"), "w4a8")
    exact = run(cpu_params, torch.device("cpu"), "nvfp4")
    quant_err = (want - exact).abs().max().item()
    bound_ = max(2 ** -5 * want.abs().max().item(), quant_err)
    err = (got - want).abs().max().item()
    log(f"[parity] w4a8 flat bf16 prefill (T={T}) logits max abs err "
        f"{err:.4e} (bound {bound_:.4e}: 2^-5 max|logits| "
        f"{2 ** -5 * want.abs().max().item():.4e}, W4A8 against nvfp4 on "
        f"the CPU {quant_err:.4e}); {n} W4A8 launches")
    if not math.isfinite(err) or err > bound_:
        raise AssertionError(f"parity w4a8 prefill: {err} > {bound_}")
    return {"w4a8 flat bf16 prefill": err,
            "w4a8 against nvfp4 on the CPU": quant_err}


def _hybrid_parity(cfg):
    """The 2-layer Llama quantized "hybrid" (every projection splits 3:1
    at this width) over the flat bf16 cache: a 64-token prefill chunk and
    one decode step on the card (hybrid_gemm, attention kernels) and on
    the CPU (twins); logits within 2^-5 * max|logits|."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    params = llama.quantize_params(llama.init_params(cfg, gen), "hybrid")
    if not all("wd" in params["layers"][0][nm] for nm in llama._QUANT_KEYS):
        raise AssertionError("parity hybrid: a projection did not split")
    cpu_params = _tree_to(params, "cpu")
    rng = np.random.default_rng(7)
    T = 64
    toks = rng.integers(0, cfg.vocab_size, size=(1, T)).astype(np.int64)
    nxt = rng.integers(0, cfg.vocab_size, size=(1, 1)).astype(np.int64)

    def run(p, d):
        cache = llama.init_cache(cfg, 1, device=d)
        lg1, cache = llama.forward(p, torch.as_tensor(toks, device=d), cfg,
                                   cache, torch.arange(T, device=d)[None],
                                   fmt="hybrid", kv_window=128)
        lg2, _ = llama.forward(p, torch.as_tensor(nxt, device=d), cfg, cache,
                               torch.full((1, 1), T, device=d), fmt="hybrid",
                               kv_window=128)
        return lg1.float().cpu(), lg2.float().cpu()

    before = hybrid.hybrid_mul.launches
    got = run(params, dev)
    n = hybrid.hybrid_mul.launches - before
    want = run(cpu_params, torch.device("cpu"))
    if n != 2 * 7 * cfg.num_layers:
        raise AssertionError(f"parity hybrid: {n} hybrid_gemm launches, "
                             f"expected {2 * 7 * cfg.num_layers}")
    out = {}
    for step, g, w in zip(("prefill", "decode"), got, want):
        bound_ = 2 ** -5 * w.abs().max().item()
        err = (g - w).abs().max().item()
        log(f"[parity] hybrid flat bf16 {step} logits max abs err "
            f"{err:.4e} (bound {bound_:.4e}); {n} hybrid_gemm launches")
        if not math.isfinite(err) or err > bound_:
            raise AssertionError(f"parity hybrid {step}: {err} > {bound_}")
        out[f"hybrid flat bf16 {step}"] = err
    return out


def _train_loss(params, toks, cfg):
    """__graft_entry__.py's loss_fn: next-token cross-entropy of
    llama.forward over toks (B, T + 1), in f32."""
    logits, _ = llama.forward(params, toks[:, :-1], cfg)
    logp = torch.log_softmax(logits.float(), -1)
    return -logp.gather(-1, toks[:, 1:, None]).mean()


def _trainable(tree, path=""):
    """{path: leaf} of the leaves a training step differentiates: all but
    the frozen packed words and scales (embed, norms, lm_head, every
    quantized layer's gs)."""
    if isinstance(tree, dict):
        return {p: w for k, v in tree.items() if k not in ("words", "scales")
                for p, w in _trainable(v, f"{path}/{k}").items()}
    if isinstance(tree, list):
        return {p: w for i, v in enumerate(tree)
                for p, w in _trainable(v, f"{path}/{i}").items()}
    return {path: tree}


def _train_copy(params):
    """params with every trainable leaf cloned and requiring a gradient,
    the frozen words and scales shared: a step updates the copy in place
    and leaves `params` as it was."""
    if isinstance(params, dict):
        return {k: v if k in ("words", "scales") else _train_copy(v)
                for k, v in params.items()}
    if isinstance(params, list):
        return [_train_copy(v) for v in params]
    return params.detach().clone().requires_grad_()


def _train_step(params, toks, cfg, lr=1e-3):
    """One step of __graft_entry__.py's train_step: loss, backward, then
    w - lr * g on every trainable leaf but the global scales (each gets its
    gradient and stays fixed: a step at lr would move a gs of about 1e-4 by
    10^4 times its value). Raises unless the loss and every gradient are
    finite. Returns the loss."""
    loss = _train_loss(params, toks, cfg)
    loss.backward()
    with torch.no_grad():
        for path, w in _trainable(params).items():
            if w.grad is None or not torch.isfinite(w.grad).all():
                raise AssertionError(f"train: gradient of {path} is missing "
                                     "or not finite")
            if not path.endswith("/gs"):
                w -= lr * w.grad.to(w.dtype)
            w.grad = None
    loss = loss.item()
    if not math.isfinite(loss):
        raise AssertionError(f"train: loss {loss}")
    return loss


def _gs_term_sizes(run):
    """run() with gemm.mul_fp4_diff wrapped so that the backward records,
    for each global scale, the size of the terms of its gradient
    sum(g * y) / gs: sum|g * y| / |gs|, keyed by the gs tensor's id.
    Returns (run()'s result, {id(gs): size})."""
    sizes, inner = {}, gemm.mul_fp4_diff

    def recording(fmt, size_k, a, b, s, gs):
        y = inner(fmt, size_k, a, b, s, gs)

        def hook(g, y=y.detach(), gs=gs.detach(), key=id(gs)):
            sizes[key] = ((g.float() * y.float()).abs().sum()
                          / gs.float().abs()).item()
        if y.requires_grad:
            y.register_hook(hook)
        return y

    gemm.mul_fp4_diff = recording
    try:
        return run(), sizes
    finally:
        gemm.mul_fp4_diff = inner


def _grad_parity():
    """A 1-layer nvfp4 Llama at full Llama-3-8B width, B = 1, 64 tokens:
    the loss and the gradients of embed, both norms, final_norm, lm_head
    and every gs on the card (fp4_gemm forward, fp4_dequant backward)
    against the CPU (twins). Loss within rel 1e-3, each gradient within
    2^-5 * max|CPU gradient|. A gs gradient is one sum over the layer's
    outputs, sum(g * y) / gs, whose terms cancel: for this random model
    they are some 10^3 times the sum (PERF.md), and card and CPU
    round the terms differently in their last bf16 bit. So the bound of a
    gs gradient is 2^-5 * max(|CPU gradient|, 2^-8 * sum|g * y| / |gs|):
    2^-5 of the sum, or of one bf16 rounding of its terms, whichever is
    larger."""
    dev = torch.device("cuda")
    cfg = llama.LlamaConfig.llama3_8b(num_layers=1)
    gen = torch.Generator(device=dev).manual_seed(8)
    params = _random_quantized(cfg, gen)
    toks = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, size=(1, 65)))
    results = []
    for d in (dev, torch.device("cpu")):
        p = _train_copy(_tree_to(params, d))
        leaves = _trainable(p)
        before = fused.dequant_tpu_layout.launches

        def step():
            loss = _train_loss(p, toks.to(d), cfg)
            loss.backward()
            return loss.item()

        loss, sizes = _gs_term_sizes(step)
        results.append(dict(
            loss=loss, launches=fused.dequant_tpu_layout.launches - before,
            grads={k: w.grad.float().cpu() for k, w in leaves.items()},
            sizes={k: sizes[id(w)] for k, w in leaves.items()
                   if k.endswith("/gs")}))
        del p, leaves
    card, cpu = results
    if card["launches"] != 4:
        raise AssertionError(f"parity grads: {card['launches']} dequant "
                             "launches, expected 4")
    out = {"grads loss card": card["loss"], "grads loss cpu": cpu["loss"]}
    log(f"[parity] grads: loss {card['loss']:.6f} on the card, "
        f"{cpu['loss']:.6f} on the CPU; {card['launches']} fp4_dequant "
        "launches")
    if not abs(card["loss"] - cpu["loss"]) <= 1e-3 * abs(cpu["loss"]):
        raise AssertionError(f"parity grads: loss {card['loss']} against "
                             f"{cpu['loss']}")
    for path in sorted(cpu["grads"]):
        g, w = card["grads"][path], cpu["grads"][path]
        scale = w.abs().max().item()
        note = ""
        if path in cpu["sizes"]:
            terms = cpu["sizes"][path]
            scale = max(scale, 2 ** -8 * terms)
            note = (f"; CPU gradient {w.item():.4e}, its terms "
                    f"sum|g*y|/|gs| {terms:.4e}")
            out[f"grads {path} terms"] = terms
        bound_ = 2 ** -5 * scale
        err = (g - w).abs().max().item()
        log(f"[parity] grads {path}: max abs err {err:.4e} (bound "
            f"{bound_:.4e}{note})")
        if not math.isfinite(err) or err > bound_:
            raise AssertionError(f"parity grads {path}: {err} > {bound_}")
        out[f"grads {path}"] = err
    return out


def _moe_parity():
    """1 layer at full Mixtral-8x7B width over the flat bf16 cache: a
    64-token prefill chunk and one decode step on the card (grouped and
    fused GEMM, attention kernels) and on the CPU (plain twins, one expert
    dequantized at a time); logits within 2^-5 * max|logits|; and the
    Mixtral Engine's score_forward on the card against the CPU chunk."""
    dev = torch.device("cuda")
    cfg = moe.MixtralConfig.mixtral_8x7b(num_layers=1)
    gen = torch.Generator(device=dev).manual_seed(4)
    params = moe.quantize_params(moe.init_params(cfg, gen), cfg)
    cpu_params = _tree_to(params, "cpu")
    rng = np.random.default_rng(4)
    T = 64
    toks = rng.integers(0, cfg.vocab_size, size=(1, T)).astype(np.int64)
    nxt = rng.integers(0, cfg.vocab_size, size=(1, 1)).astype(np.int64)

    def run(p, d):
        cache = llama.init_cache(cfg, 1, device=d)
        lg1, cache = moe.forward(p, torch.as_tensor(toks, device=d), cfg,
                                 cache, torch.arange(T, device=d)[None],
                                 kv_window=128)
        lg2, _ = moe.forward(p, torch.as_tensor(nxt, device=d), cfg, cache,
                             torch.full((1, 1), T, device=d), kv_window=128)
        return lg1.float().cpu(), lg2.float().cpu()

    out = {}
    got, want = run(params, dev), run(cpu_params, torch.device("cpu"))
    for step, g, w in zip(("prefill", "decode"), got, want):
        bound_ = 2 ** -5 * w.abs().max().item()
        err = (g - w).abs().max().item()
        log(f"[parity] Mixtral flat bf16 {step} logits max abs err "
            f"{err:.4e} (bound {bound_:.4e})")
        if not math.isfinite(err) or err > bound_:
            raise AssertionError(f"parity Mixtral {step}: {err} > {bound_}")
        out[f"Mixtral flat bf16 {step}"] = err
    eng = serving.Engine(params, cfg, max_batch=1,
                         forward_fn=moe.make_engine_forward(cfg))
    _check_score("Mixtral flat bf16 Engine", eng.score_forward(toks),
                 want[0], out)
    return out


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    # a hybrid layer's HybridMeta is no tensor
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


_SERVE_MODEL = {}


def _serve_model(cfg, dev):
    """The full-depth model of the serve phase: random weights from seed 0,
    quantized nvfp4 on the card. Built once and shared with `profile`."""
    if "params" not in _SERVE_MODEL:
        gen = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        params = {"layers": []}
        # one layer at a time, so the dense bf16 copy never holds all 32
        dense = llama.init_params(llama.LlamaConfig.llama3_8b(num_layers=0),
                                  gen)
        params.update({k: v for k, v in dense.items() if k != "layers"})
        one = llama.LlamaConfig.llama3_8b(num_layers=1, vocab_size=16)
        for _ in range(cfg.num_layers):
            params["layers"] += _random_quantized(one, gen)["layers"]
        torch.cuda.synchronize()
        _SERVE_MODEL.update(params=params, init_s=time.perf_counter() - t0)
    return _SERVE_MODEL["params"], _SERVE_MODEL["init_s"]


def _serve_requests(cfg):
    """The 8 seeded greedy requests of the serve phases: prompt lengths in
    [16, 300], one of 300 (two prefill chunks), 32 new tokens each."""
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 301, size=8)
    lens[1] = 300                       # one prompt takes two chunks
    return [serving.Request(uid=i, tokens=rng.integers(
        0, cfg.vocab_size, size=int(n)).astype(np.int32), max_new_tokens=32)
        for i, n in enumerate(lens)]


def _kv_size(tensors) -> int:
    return sum(t.numel() * t.element_size() for kv in tensors for t in kv)


def _check_outputs(path, out, n_reqs, cfg):
    """Every request finished with its 32 tokens, each a vocabulary id."""
    if sorted(out) != list(range(n_reqs)) or any(
            len(v) != 32 for v in out.values()):
        raise AssertionError(f"{path}: bad outputs {out}")
    if not all(0 <= t < cfg.vocab_size for v in out.values() for t in v):
        raise AssertionError(f"{path}: token id out of range")


def _serve(rec, path, make_engine, reqs, cfg):
    """Build an engine with make_engine() on a freshly reset peak-memory
    counter, then serve `reqs` to completion through its add_request and
    step, with every kernel's launch count set to 0 just before and read
    just after; check the outputs and that every kernel of `path`
    launched. Returns (the run's record, the engine)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = make_engine()
    ticks, decode_launches = _count_decode_launches(eng)
    _reset_launches()
    pending, peak_pages = list(reqs), 0
    t0 = time.perf_counter()
    while pending or eng.active.any() or eng._pf:
        while pending and eng.has_capacity():
            eng.add_request(pending.pop(0))
        eng.step()
        if isinstance(eng, serving.PagedEngine):
            peak_pages = max(peak_pages, eng.pages_in_use())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    out = eng.finished
    _check_outputs(path, out, len(reqs), cfg)
    missing = [k for k in PATHS[path] if launches[k] == 0]
    if missing:
        raise AssertionError(f"{path}: kernels never launched: {missing} "
                             f"({launches})")
    for k in PATHS[path]:
        if k.startswith("kv_append") \
                and decode_launches[k] != cfg.num_layers * ticks[0]:
            raise AssertionError(
                f"{path}: {k} launched {decode_launches[k]} times in "
                f"{ticks[0]} decode steps, not once a layer a step")
    for name, n in launches.items():
        rec["launches"][name] = rec["launches"].get(name, 0) + n
    n_tok = sum(len(v) for v in out.values())
    run = dict(wall_s=wall, new_tokens=n_tok, tok_per_s=n_tok / wall,
               launches=launches, decode_launches=dict(decode_launches),
               tokens=[out[i] for i in sorted(out)],
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               decode_ticks=ticks[0],
               launches_per_decode_step={
                   k: v / ticks[0] for k, v in decode_launches.items() if v})
    if peak_pages:
        run["peak_pages_in_use"] = peak_pages
    log(f"[{path}] {n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} "
        f"tok/s; peak device memory {run['peak_gib']:.2f} GiB")
    log(json.dumps({"path": path, "launches": launches,
                    "decode_ticks": ticks[0],
                    "launches_per_decode_step":
                        run["launches_per_decode_step"]}))
    return run, eng


def _launch_counts() -> dict:
    return {name: getattr(info["wrapper"], info.get("counter", "launches"))
            for name, info in KERNELS.items()}


def _reset_launches() -> None:
    for info in KERNELS.values():
        setattr(info["wrapper"], info.get("counter", "launches"), 0)


def _calls(launches: dict) -> int:
    """Wrapper calls that launched: the counts, less those that count a
    part of another wrapper's launches (fp4_gemm_prefill)."""
    return sum(n for name, n in launches.items()
               if "counter" not in KERNELS[name])


def _count_decode_launches(eng):
    """Wrap eng._decode so that it counts decode ticks and the kernel
    launches made inside them; returns ([ticks], {kernel: launches})."""
    ticks, launches = [0], dict.fromkeys(KERNELS, 0)
    inner = eng._decode

    def counted():
        before = _launch_counts()
        out = inner()
        for name, n in _launch_counts().items():
            launches[name] += n - before[name]
        ticks[0] += 1
        return out

    eng._decode = counted
    return ticks, launches


def phase_serve(rec):
    dev = torch.device("cuda")
    cfg = llama.LlamaConfig.llama3_8b()
    params, t_init = _serve_model(cfg, dev)
    reqs = _serve_requests(cfg)
    lens = [len(r.tokens) for r in reqs]
    log(f"[serve] params ready in {t_init:.1f} s; prompt lengths {lens}; "
        f"device memory {torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    rec.setdefault("launches", {})
    run, eng = _serve(rec, "serve bf16 Engine",
                      lambda: serving.Engine(params, cfg, max_batch=4),
                      reqs, cfg)
    run.update(prompt_lens=lens, init_s=t_init, kv_bytes=_kv_size(eng.cache))
    rec["serve"] = run
    log(f"[serve] includes prefill of {sum(lens)} prompt tokens; flat bf16 "
        f"KV cache {run['kv_bytes'] / 2**20:.1f} MiB")


def phase_serve_kv(rec):
    """The serve phase's model and requests over the fp8 KV caches: the
    headed contiguous cache of Engine and PagedEngine's page pool."""
    dev = torch.device("cuda")
    cfg = llama.LlamaConfig.llama3_8b()
    params, _ = _serve_model(cfg, dev)
    reqs = _serve_requests(cfg)
    rec.setdefault("launches", {})
    # serve's flat bf16 cache: K and V, 4 slots, 2 bytes a value
    flat_bytes = (2 * cfg.num_layers * 4 * cfg.max_seq_len
                  * cfg.num_kv_heads * cfg.head_dim * 2)
    bf16_tokens = rec.get("serve", {}).get("tokens")
    out = {"flat_bf16_kv_bytes": flat_bytes}
    for path, make in (
            ("serve_kv fp8 Engine",
             lambda: serving.Engine(params, cfg, max_batch=4,
                                    cache_dtype=FP8)),
            ("serve_kv fp8 PagedEngine",
             lambda: serving.PagedEngine(params, cfg, max_batch=4,
                                         page_size=16, cache_dtype=FP8))):
        run, eng = _serve(rec, path, make, reqs, cfg)
        if isinstance(eng, serving.PagedEngine):
            pc = eng.pc
            _pages_back(path, eng)
            run["kv_bytes"] = _kv_size(pc.pages)
            page_bytes = run["kv_bytes"] // (pc.num_pages + 1)
            run["peak_kv_bytes_in_use"] = run["peak_pages_in_use"] * page_bytes
            log(f"[{path}] pool {run['kv_bytes'] / 2**20:.1f} MiB "
                f"({pc.num_pages} + 1 pages of {page_bytes} B); peak "
                f"{run['peak_pages_in_use']} pages = "
                f"{run['peak_kv_bytes_in_use'] / 2**20:.1f} MiB in use; "
                f"all pages back in the pool")
        else:
            run["kv_bytes"] = _kv_size(eng.cache)
        log(f"[{path}] KV {run['kv_bytes'] / 2**20:.1f} MiB against "
            f"{flat_bytes / 2**20:.1f} MiB for serve's flat bf16 cache")
        if bf16_tokens:       # information: fp8 KV against bf16 KV streams
            same = sum(a == b for x, y in zip(run["tokens"], bf16_tokens)
                       for a, b in zip(x, y))
            run["tokens_equal_to_bf16"] = same
            log(f"[{path}] {same} of {run['new_tokens']} tokens equal to "
                "the bf16 Engine's")
        run.update(_score_pairs(path, eng, cfg))
        out[path] = run
        del eng
    rec["serve_kv"] = out


def _score_pairs(path, eng, cfg, n=8):
    """eval.loglikelihood of n seeded (context, continuation) pairs
    (contexts of 20 to 200 tokens, continuations of 1 to 8) through the
    engine's score_forward: seconds and scores as information; fails on a
    non-finite score."""
    rng = np.random.default_rng(8)
    pairs = [([int(t) for t in rng.integers(0, cfg.vocab_size,
                                            rng.integers(20, 201))],
              [int(t) for t in rng.integers(0, cfg.vocab_size,
                                            rng.integers(1, 9))])
             for _ in range(n)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = port_eval.loglikelihood(None, None, pairs, engine=eng)
    sec = time.perf_counter() - t0
    log(f"[{path}] eval.loglikelihood of {n} pairs through score_forward: "
        f"{sec:.2f} s; scores {np.round(scores, 3).tolist()}")
    if not np.isfinite(scores).all():
        raise AssertionError(f"{path}: a non-finite score {scores}")
    return {"score_s": sec, "scores": scores.tolist()}


def _count_captures(eng):
    """Give eng its decode blocks' device half now and wrap the step it
    captures (_DecodeBlocks._step, which runs only at capture on the
    card), so that it counts the kernel launches of each captured step;
    returns {kv_window: {kernel: launches}}. Replays move no counter."""
    eng._blocks = serving._DecodeBlocks(eng)
    captured = {}
    inner = eng._blocks._step

    def counted(window):
        before = _launch_counts()
        out = inner(window)
        captured[window] = {k: n - before[k] for k, n in
                            _launch_counts().items() if n > before[k]}
        return out

    eng._blocks._step = counted
    return captured


def _kv_tensors(eng):
    return eng.cache if eng.cache is not None else eng.pc.pages


def _kv_bytes(eng, end):
    """The KV a block must reproduce, as byte tensors: every byte of a
    contiguous cache; of a page pool, each active slot's K and V of every
    layer gathered through its own block-table row over positions <
    end[slot] (a block takes a slot's pages for the whole block up front,
    eager steps one at a time, so their physical pages differ)."""
    if eng.cache is not None:
        return [t.view(torch.uint8).clone() for kv in eng.cache for t in kv]
    return [t.view(torch.uint8) for slot in np.flatnonzero(eng.active)
            for t in paged.gather_slot_kv(eng.pc, slot, int(end[slot]))]


def _block_replay_check(eng, reqs, steps=8):
    """After admitting the first max_batch requests: `steps` eager decode
    steps (step()'s forward and sample_next) from a snapshot of the KV
    (cache or page pools), the host state and a PagedEngine's allocator,
    then one block of `steps` from the restored snapshot through the step
    graphs (_run_decode_block: a PagedEngine's pages for the block first);
    returns whether tokens and the KV (_kv_bytes) are equal, and the
    block's ms (wall, its one read included)."""
    eng.reset()
    for r in reqs[:eng.B]:
        eng.add_request(r)
    while eng._pf:
        eng._advance_prefill()
    snap = [(k.clone(), v.clone()) for k, v in _kv_tensors(eng)]
    pos, last = eng.pos.copy(), eng.last_tok.copy()
    gstate = eng.generator.get_state()
    pc = getattr(eng, "pc", None)
    alloc = pc.allocator_state() if pc is not None else None
    want = []
    for _ in range(steps):
        want.append(eng._decode())
        eng.pos[eng.active] += 1
        eng.last_tok[eng.active] = want[-1][eng.active]
    end = eng.pos.copy()
    want_kv = _kv_bytes(eng, end)
    for (k, v), (k0, v0) in zip(_kv_tensors(eng), snap):
        k.copy_(k0)
        v.copy_(v0)
    del snap
    eng.pos[:], eng.last_tok[:] = pos, last
    eng.generator.set_state(gstate)
    if pc is not None:
        pc.restore_allocator(alloc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = eng._read_block(eng._run_decode_block(eng.last_tok, eng.pos, steps))
    ms = (time.perf_counter() - t0) * 1e3
    same_toks = bool((got == np.stack(want)).all())
    got_kv = _kv_bytes(eng, end)
    same_cache = len(got_kv) == len(want_kv) and all(
        torch.equal(x, y) for x, y in zip(got_kv, want_kv))
    del want_kv, got_kv
    eng.reset()
    return same_toks, same_cache, ms


def _pages_back(path, eng):
    """Fails unless every page of a PagedEngine is back in its pool."""
    if isinstance(eng, serving.PagedEngine):
        pc = eng.pc
        if eng.pages_in_use() != 0 or sorted(pc.free) != list(
                range(pc.num_pages)):
            raise AssertionError(f"{path}: {eng.pages_in_use()} pages still "
                                 "in use after the run")


def _serve_block(rec, path, make_engine, reqs, cfg, single_tokens):
    """Build an engine with make_engine() on a freshly reset peak-memory
    counter and serve `reqs` through run(reqs, decode_block=8), with every
    kernel's launch count set to 0 just before and read just after; check
    the outputs, that every kernel of `path` launched, that each captured
    step launched its layout's KV append once a layer (and the launches of
    CAPTURED_PER_LAYER[path]) and, for a PagedEngine, that every page is
    back in the pool. Then the same run again on the engine whose graphs
    exist (same tokens), and _block_replay_check. Returns the run's
    record."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = make_engine()
    captured = _count_captures(eng)
    _reset_launches()
    t0 = time.perf_counter()
    out = eng.run(reqs, decode_block=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    _check_outputs(path, out, len(reqs), cfg)
    missing = [k for k in PATHS[path] if launches[k] == 0]
    if missing:
        raise AssertionError(f"{path}: kernels never launched: {missing} "
                             f"({launches})")
    per_layer = {k: 1 for k in PATHS[path] if k.startswith("kv_append")}
    per_layer.update(CAPTURED_PER_LAYER.get(path, {}))
    for window, counts in captured.items():
        for k, n in per_layer.items():
            if counts.get(k, 0) != n * cfg.num_layers:
                raise AssertionError(
                    f"{path}: the step captured at window {window} launched "
                    f"{k} {counts.get(k, 0)} times, not {n} a layer")
    _pages_back(path, eng)
    for name, n in launches.items():
        rec["launches"][name] = rec["launches"].get(name, 0) + n
    blocks = eng._blocks
    n_tok = sum(len(v) for v in out.values())
    tokens = [out[i] for i in sorted(out)]
    run = dict(wall_s=wall, new_tokens=n_tok, tok_per_s=n_tok / wall,
               launches=launches, tokens=tokens,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               graphs=sorted(blocks.graphs), capture_s=blocks.capture_s,
               launches_per_captured_step={str(w): c for w, c in
                                           captured.items()})
    # the same run on the engine whose graphs exist
    eng.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = eng.run(reqs, decode_block=8)
    torch.cuda.synchronize()
    run["warm_wall_s"] = time.perf_counter() - t0
    run["warm_tok_per_s"] = n_tok / run["warm_wall_s"]
    if again != out:
        raise AssertionError(f"{path}: a second run on the same engine gave "
                             "other tokens")
    _pages_back(path, eng)
    if single_tokens:     # information: run schedules otherwise than step()
        same = sum(a == b for x, y in zip(tokens, single_tokens)
                   for a, b in zip(x, y))
        run["tokens_equal_to_decode_block_1"] = same
    same_toks, same_cache, block_ms = _block_replay_check(eng, reqs)
    run.update(replay_check_tokens=same_toks, replay_check_cache=same_cache,
               replay_check_block_ms=block_ms,
               graphs_after_check=sorted(blocks.graphs),
               capture_s_total=blocks.capture_s,
               peak_gib_with_check=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[{path}] {n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} tok/s "
        f"(graphs captured in the run: {len(captured)}, windows "
        f"{sorted(captured)}, {blocks.capture_s:.2f} s of capture); warm "
        f"{run['warm_tok_per_s']:.1f} tok/s; peak device memory "
        f"{run['peak_gib']:.2f} GiB")
    log(f"[{path}] launches per captured step: "
        f"{run['launches_per_captured_step']}")
    if single_tokens:
        log(f"[{path}] {run['tokens_equal_to_decode_block_1']} of {n_tok} "
            "tokens equal to the decode_block=1 run's")
    log(f"[{path}] snapshot check: 8 eager steps against one block of 8, "
        f"tokens {'equal' if same_toks else 'DIFFER'}, "
        f"{'per-slot KV' if eng.cache is None else 'cache'} bytes "
        f"{'equal' if same_cache else 'DIFFER'}; the block {block_ms:.1f} "
        "ms with its read")
    _pages_back(path, eng)
    if not (same_toks and same_cache):
        raise AssertionError(f"{path}: a block of 8 is not bit for bit 8 "
                             "eager steps")
    del eng
    return run


def phase_serve_block(rec):
    """serve's model and requests through run(reqs, decode_block=8): Engine
    over the flat bf16 cache and over the headed fp8 cache, and
    PagedEngine over an fp8 pool of page size 16, each decode step of a
    block a replay of the captured step graph of its window bucket
    (_serve_block)."""
    dev = torch.device("cuda")
    cfg = llama.LlamaConfig.llama3_8b()
    params, _ = _serve_model(cfg, dev)
    reqs = _serve_requests(cfg)
    rec.setdefault("launches", {})
    single = {"serve_block bf16 Engine": rec.get("serve", {}),
              "serve_block fp8 Engine": rec.get("serve_kv", {}).get(
                  "serve_kv fp8 Engine", {}),
              "serve_block fp8 PagedEngine": rec.get("serve_kv", {}).get(
                  "serve_kv fp8 PagedEngine", {})}
    out = {}
    for path, make in (
            ("serve_block bf16 Engine",
             lambda: serving.Engine(params, cfg, max_batch=4)),
            ("serve_block fp8 Engine",
             lambda: serving.Engine(params, cfg, max_batch=4,
                                    cache_dtype=FP8)),
            ("serve_block fp8 PagedEngine",
             lambda: serving.PagedEngine(params, cfg, max_batch=4,
                                         page_size=16, cache_dtype=FP8))):
        run = _serve_block(rec, path, make, reqs, cfg,
                           single[path].get("tokens"))
        if "tok_per_s" in single[path]:
            run["decode_block_1_tok_per_s"] = single[path]["tok_per_s"]
            base = single[path]["tok_per_s"]
            log(f"[{path}] against decode_block=1 in this call: "
                f"{run['tok_per_s'] / base:.2f}x (warm "
                f"{run['warm_tok_per_s'] / base:.2f}x)")
        out[path] = run
    rec["serve_block"] = out


_MOE_MODEL = {}


def _moe_model(cfg, dev):
    """The full-depth Mixtral of the serve_moe phase: random weights from
    seed 0, built and quantized on the card one layer (and one expert) at
    a time, experts mxfp4 and attention nvfp4. Shared with `profile`."""
    if "params" not in _MOE_MODEL:
        gen = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        params = moe.init_params(dataclasses.replace(cfg, num_layers=0), gen)
        one = dataclasses.replace(cfg, num_layers=1, vocab_size=16)
        for _ in range(cfg.num_layers):
            params["layers"] += moe.quantize_params(
                moe.init_params(one, gen), one)["layers"]
        torch.cuda.synchronize()
        _MOE_MODEL.update(params=params, init_s=time.perf_counter() - t0)
    return _MOE_MODEL["params"], _MOE_MODEL["init_s"]


@torch.inference_mode()
def _chunk_drops(params, cfg, toks):
    """routing_drop_count of each layer for one chunk toks (1, T), through
    moe.forward's own steps without a cache (information only)."""
    moe_cfg = moe.MoEConfig(cfg.num_experts, cfg.top_k)
    T = toks.shape[1]
    pos = torch.arange(T, device=toks.device)[None]
    rope_cs = llama._rope_angles(pos, cfg.head_dim, cfg.rope_theta)
    x, drops = params["embed"][toks], []
    for lp in params["layers"]:
        h = llama.rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        x = x + llama.attention(h, lp, None, pos, cfg, fmt="nvfp4",
                                rope_cs=rope_cs)
        h = llama.rms_norm(x, lp["mlp_norm"], cfg.rms_eps).reshape(T, -1)
        drops.append(moe.routing_drop_count(h, lp["router"], moe_cfg))
        x = x + moe.moe_mlp(h, lp["router"], lp["experts"],
                            moe_cfg).reshape(1, T, -1)
    return [int(d) for d in drops]


def _weight_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_weight_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_weight_bytes(v) for v in tree)
    if not isinstance(tree, torch.Tensor):    # HybridMeta
        return 0
    return tree.numel() * tree.element_size()


def phase_serve_moe(rec):
    """The 32-layer Mixtral-8x7B through Engine(forward_fn=...) over the
    flat bf16 cache, serving the serve phase's 8 requests."""
    dev = torch.device("cuda")
    cfg = MIXTRAL_8X7B
    params, t_init = _moe_model(cfg, dev)
    reqs = _serve_requests(cfg)
    wbytes = _weight_bytes(params)
    log(f"[serve_moe] params ready in {t_init:.1f} s; {wbytes / 1e9:.2f} GB "
        f"of weights; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    chunk = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(1, 256)), device=dev)
    drops = _chunk_drops(params, cfg, chunk)
    log(f"[serve_moe] routing_drop_count of one 256-token chunk (cap "
        f"{moe.capacity(256, moe.MoEConfig())}), per layer: {drops}")
    rec.setdefault("launches", {})
    run, eng = _serve(rec, "serve_moe Mixtral Engine",
                      lambda: serving.Engine(
                          params, cfg, max_batch=4,
                          forward_fn=moe.make_engine_forward(cfg)),
                      reqs, cfg)
    run.update(init_s=t_init, weight_bytes=wbytes,
               kv_bytes=_kv_size(eng.cache), chunk_drops=drops)
    log(f"[serve_moe] flat bf16 KV cache {run['kv_bytes'] / 2**20:.1f} MiB")
    del eng
    # the same model and requests in decode blocks
    path = "serve_moe Mixtral Engine decode_block=8"
    block = _serve_block(rec, path, lambda: serving.Engine(
        params, cfg, max_batch=4, forward_fn=moe.make_engine_forward(cfg)),
        reqs, cfg, run["tokens"])
    block["decode_block_1_tok_per_s"] = run["tok_per_s"]
    log(f"[{path}] against decode_block=1 in this call: "
        f"{block['tok_per_s'] / run['tok_per_s']:.2f}x (warm "
        f"{block['warm_tok_per_s'] / run['tok_per_s']:.2f}x); peak device "
        f"memory {block['peak_gib']:.2f} GiB against "
        f"{run['peak_gib']:.2f} eager")
    run["decode_block_8"] = block
    rec["serve_moe"] = run


def phase_serve_w4a8(rec):
    """serve's model and requests with prefill_fmt="w4a8": Engine over the
    flat bf16 cache and PagedEngine over the fp8 pool (page size 16). Every
    prefill GEMM of 256 rows or more takes the W4A8 kernel, fewer rows the
    exact one, and decode stays exact; the runs count both and compare the
    token streams with those of the same engine with nvfp4 prefill in
    serve and serve_kv (information). Then the weight-cache kernels' own
    path (_weight_cache_api_run)."""
    dev = torch.device("cuda")
    cfg = llama.LlamaConfig.llama3_8b()
    params, _ = _serve_model(cfg, dev)
    reqs = _serve_requests(cfg)
    rec.setdefault("launches", {})
    nvfp4_tokens = {
        "serve_w4a8 bf16 Engine": rec.get("serve", {}).get("tokens"),
        "serve_w4a8 fp8 PagedEngine": rec.get("serve_kv", {}).get(
            "serve_kv fp8 PagedEngine", {}).get("tokens")}
    out = {}
    for path, make in (
            ("serve_w4a8 bf16 Engine",
             lambda: serving.Engine(params, cfg, max_batch=4,
                                    prefill_fmt="w4a8")),
            ("serve_w4a8 fp8 PagedEngine",
             lambda: serving.PagedEngine(params, cfg, max_batch=4,
                                         page_size=16, cache_dtype=FP8,
                                         prefill_fmt="w4a8"))):
        wgmma0 = fused.fused_mul_w4a8.wgmma_launches
        run, eng = _serve(rec, path, make, reqs, cfg)
        dec = run["decode_launches"]
        if dec["fp4_gemm_w4a8"]:
            raise AssertionError(f"{path}: a decode step launched the W4A8 "
                                 "kernel")
        run["prefill_gemm_launches"] = dict(
            w4a8=run["launches"]["fp4_gemm_w4a8"],
            w4a8_wgmma=fused.fused_mul_w4a8.wgmma_launches - wgmma0,
            exact=run["launches"]["fp4_gemm"] - dec["fp4_gemm"])
        if run["prefill_gemm_launches"]["w4a8_wgmma"] != run["launches"][
                "fp4_gemm_w4a8"]:
            raise AssertionError(f"{path}: a W4A8 launch missed the 64-row "
                                 "int8 wgmma tiles")
        log(f"[{path}] prefill GEMM launches: "
            f"{run['prefill_gemm_launches']['w4a8']} W4A8 (all on the "
            "64-row int8 wgmma tiles), "
            f"{run['prefill_gemm_launches']['exact']} exact (m < "
            f"{llama.W4A8_MIN_M}); prefill chunk {eng.prefill_chunk}")
        if isinstance(eng, serving.PagedEngine) and (
                eng.pages_in_use() != 0
                or sorted(eng.pc.free) != list(range(eng.pc.num_pages))):
            raise AssertionError(f"{path}: pages still in use after the run")
        if nvfp4_tokens[path]:   # information: W4A8 against nvfp4 prefill
            same = sum(x == y for x, y in zip(run["tokens"],
                                              nvfp4_tokens[path]))
            run["streams_equal_to_nvfp4_prefill"] = same
            log(f"[{path}] {same} of {len(reqs)} token streams equal to "
                "the same engine's with nvfp4 prefill")
        out[path] = run
        del eng
    out["gemm_api weight-cache ids"] = _weight_cache_api_run(rec, params,
                                                             cfg)
    rec["serve_w4a8"] = out


def _weight_cache_api_run(rec, params, cfg):
    """The weight-cache kernels' path: layer 0's four projections, one
    512-row chunk each, through gemm.mul_nvfp4_a16 and gemm.mul_nvfp4_a8
    with explicit weight-cache solution ids (64 x 128 tiles, 4 m-tiles a
    CTA), and its first 64 rows through mul_nvfp4_a16 with a 16 x 64
    weight-cache id (the 16-row stream tiles, 4 m-tiles a CTA), as an
    autotuner calls them. The launch counts are set to 0 just before and
    read just after; the outputs are checked afterwards (the 16-row ones
    against the 64-row ones' first rows at the GEMM tolerance)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    m, m16 = 512, 64
    wc16 = solution_mod.SolutionId(64, 128, weight_cache=True)
    wc_stream = solution_mod.SolutionId(16, 64, weight_cache=True)
    wc8 = solution_mod.SolutionId(64, 128, mfma_type=solution_mod.MatmulType
                                  .INT8, weight_cache=True)
    jobs = []
    for name in ("wqkv", "wo", "w_gateup", "w_down"):
        layer = params["layers"][0][name]
        k, n = layer["words"].shape[0] * 8, layer["words"].shape[1]
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        jobs.append((x, layer, n, k,
                     *fused.w4a8_requant_constants(layer["scales"])))
    torch.cuda.synchronize()
    _reset_launches()
    wc_wgmma0 = fused.fused_mul_w4a8_wc.wgmma_launches
    outs, outs_stream = [], []
    for x, layer, n, k, r_t, acol in jobs:
        args = (x, layer["words"], layer["scales"], layer["gs"], m, n, k)
        outs.append(gemm.mul_nvfp4_a16(*args, wc16.repr()))
        outs.append(gemm.mul_nvfp4_a8(*args, wc8.repr(), r_t=r_t,
                                      acol=acol))
        outs_stream.append(gemm.mul_nvfp4_a16(
            x[:m16], layer["words"], layer["scales"], layer["gs"], m16, n, k,
            wc_stream.repr()))
    torch.cuda.synchronize()
    launches = _launch_counts()
    path = "gemm_api weight-cache ids"
    missing = [k for k in PATHS[path] if launches[k] == 0]
    if missing:
        raise AssertionError(f"{path}: kernels never launched: {missing} "
                             f"({launches})")
    for k in PATHS[path]:
        if k.startswith("kv_append") \
                and decode_launches[k] != cfg.num_layers * ticks[0]:
            raise AssertionError(
                f"{path}: {k} launched {decode_launches[k]} times in "
                f"{ticks[0]} decode steps, not once a layer a step")
    if (fused.fused_mul_w4a8_wc.wgmma_launches - wc_wgmma0
            != launches["fp4_gemm_w4a8_wc"]):
        raise AssertionError(f"{path}: a W4A8 weight-cache launch missed "
                             "the 64-row int8 wgmma tiles")
    for (x, layer, n, k, _, _), y16, y8, ys in zip(jobs, outs[::2],
                                                    outs[1::2], outs_stream):
        for y in (y16, y8):
            if tuple(y.shape) != (m, n) or not torch.isfinite(y).all():
                raise AssertionError(f"{path}: bad output {tuple(y.shape)}")
        _close(f"{path}: 16-row weight cache k={k}", ys, y16[:m16], 2 ** -7,
               2 ** -8 * y16[:m16].float().abs().max())
        rel = ((y8.float() - y16.float()).norm() / y16.float().norm()).item()
        if not rel < 0.03:
            raise AssertionError(f"{path}: W4A8 {rel} from bf16 (k={k})")
    for name, n_ in launches.items():
        rec["launches"][name] = rec["launches"].get(name, 0) + n_
    log(json.dumps({"path": path, "launches": launches}))
    return dict(m=m, launches=launches)


_HYBRID_MODEL = {}


def _hybrid_model(cfg, dev):
    """serve's model quantized "hybrid": the same dense weights (seed 0,
    drawn in the same order), every projection split 3:1 into FP4 and bf16
    columns on the card, one layer at a time. Shared with `profile`."""
    if "params" not in _HYBRID_MODEL:
        gen = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        params = llama.init_params(dataclasses.replace(cfg, num_layers=0),
                                   gen)
        one = dataclasses.replace(cfg, num_layers=1, vocab_size=16)
        for _ in range(cfg.num_layers):
            params["layers"] += llama.quantize_params(
                llama.init_params(one, gen), "hybrid")["layers"]
        torch.cuda.synchronize()
        _HYBRID_MODEL.update(params=params, init_s=time.perf_counter() - t0)
    return _HYBRID_MODEL["params"], _HYBRID_MODEL["init_s"]


def phase_serve_hybrid(rec):
    """serve's requests through Engine(max_batch=4, fmt="hybrid") over the
    flat bf16 cache. Every projection of Llama-3-8B splits, so a decode
    step launches hybrid_gemm 7 times a layer and fp4_gemm never."""
    dev = torch.device("cuda")
    cfg = llama.LlamaConfig.llama3_8b()
    params, t_init = _hybrid_model(cfg, dev)
    reqs = _serve_requests(cfg)
    wbytes = _weight_bytes(params)
    nvfp4_bytes = (_weight_bytes(_SERVE_MODEL["params"])
                   if "params" in _SERVE_MODEL else None)
    log(f"[serve_hybrid] params ready in {t_init:.1f} s; {wbytes / 1e9:.2f} "
        f"GB of weights (nvfp4 model: "
        f"{'not built' if nvfp4_bytes is None else f'{nvfp4_bytes / 1e9:.2f} GB'}"
        f"); device memory {torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    rec.setdefault("launches", {})
    path = "serve_hybrid bf16 Engine"
    run, eng = _serve(rec, path, lambda: serving.Engine(
        params, cfg, max_batch=4, fmt="hybrid"), reqs, cfg)
    per_step = run["launches_per_decode_step"]
    if per_step.get("hybrid_gemm") != 7 * cfg.num_layers \
            or per_step.get("fp4_gemm"):
        raise AssertionError(f"{path}: launches per decode step {per_step}, "
                             f"expected {7 * cfg.num_layers} hybrid_gemm and "
                             "no fp4_gemm")
    run.update(init_s=t_init, weight_bytes=wbytes,
               nvfp4_weight_bytes=nvfp4_bytes, kv_bytes=_kv_size(eng.cache))
    nvfp4_tokens = rec.get("serve", {}).get("tokens")
    if nvfp4_tokens:          # information: the same weights, nvfp4
        same = sum(x == y for x, y in zip(run["tokens"], nvfp4_tokens))
        run["streams_equal_to_nvfp4"] = same
        log(f"[{path}] {same} of {len(reqs)} token streams equal to "
            "serve's (the same dense weights quantized nvfp4)")
    rec["serve_hybrid"] = run
    del eng


def _train_tokens(cfg):
    """phase train's 513 seeded tokens, B = 1 (T = 512 positions)."""
    return torch.as_tensor(np.random.default_rng(9).integers(
        0, cfg.vocab_size, size=(1, 513)), device="cuda")


def phase_train(rec):
    """3 training steps of serve's 32-layer nvfp4 Llama-3-8B on 513 seeded
    tokens (B = 1, T = 512) through _train_step, on a copy of its trainable
    leaves (the words and scales are shared and frozen). The launch counts
    are set to 0 before the steps and read after them: the dequant kernel
    must have launched once per quantized projection per step, 128 times.
    The loss is printed, not held to fall: at this width an update of 1e-3
    * g to a bf16 weight of about 0.02, or to a unit norm, can round
    away."""
    dev = torch.device("cuda")
    cfg = llama.LlamaConfig.llama3_8b()
    serve_params, _ = _serve_model(cfg, dev)
    toks = _train_tokens(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**30
    params = _train_copy(serve_params)
    _reset_launches()
    losses, step_s, dequants = [], [], []
    for _ in range(3):
        before = fused.dequant_tpu_layout.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(_train_step(params, toks, cfg))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        dequants.append(fused.dequant_tpu_layout.launches - before)
    launches = _launch_counts()
    path = "train nvfp4 Llama"
    missing = [k for k in PATHS[path] if launches[k] == 0]
    if missing:
        raise AssertionError(f"{path}: kernels never launched: {missing} "
                             f"({launches})")
    for k in PATHS[path]:
        if k.startswith("kv_append") \
                and decode_launches[k] != cfg.num_layers * ticks[0]:
            raise AssertionError(
                f"{path}: {k} launched {decode_launches[k]} times in "
                f"{ticks[0]} decode steps, not once a layer a step")
    if dequants != [4 * cfg.num_layers] * 3:
        raise AssertionError(f"{path}: fp4_dequant launches per step "
                             f"{dequants}, expected {4 * cfg.num_layers}")
    rec.setdefault("launches", {})
    for name, n_ in launches.items():
        rec["launches"][name] = rec["launches"].get(name, 0) + n_
    peak = torch.cuda.max_memory_allocated() / 2**30
    rec["train"] = dict(tokens=int(toks.shape[1]), losses=losses,
                        step_s=step_s, peak_gib=peak, resident_gib=base,
                        launches=launches,
                        launches_per_step={k: v / 3 for k, v in
                                           launches.items() if v})
    log(f"[train] 3 steps, B=1 T={toks.shape[1] - 1}: losses "
        f"{[round(x, 6) for x in losses]}; step times "
        f"{[round(x, 3) for x in step_s]} s; peak device memory "
        f"{peak:.2f} GiB ({base:.2f} GiB resident before the steps, the "
        f"served models included)")
    log(json.dumps({"path": path, "launches": launches}))
    del params
    gc.collect()
    torch.cuda.empty_cache()


# -- load: the HF checkpoint loader ------------------------------------------

_ST_NAMES = {torch.bfloat16: "BF16", torch.float32: "F32",
             torch.uint8: "U8", FP8: "F8_E4M3"}


def _write_safetensors(file, tensors: dict) -> None:
    """A small writer of the safetensors format (the card's host has no
    safetensors package): an 8-byte little-endian header length, the JSON
    header (dtype, shape, data_offsets of each tensor, padded with spaces
    to 8 bytes), then each tensor's bytes in order."""
    header, off, blobs = {}, 0, []
    for name, t in tensors.items():
        t = t.detach().contiguous().cpu()
        size = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + size]}
        blobs.append(t.reshape(-1).view(torch.uint8).numpy())
        off += size
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(file, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for b in blobs:
            f.write(b)


_HF_PROJ = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
            "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
            "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
            "w_down": "mlp.down_proj"}


def _load_checkpoint(cfg, dev):
    """A 2-layer checkpoint at Llama-3-8B's widths, seeded on the card: the
    HF tensors, bf16 (projections (n, k), norms near 1, tied embeddings),
    by HF name."""
    gen = torch.Generator(device=dev).manual_seed(5)
    h = cfg.hidden_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    f = cfg.intermediate_size
    shapes = {"wq": (q, h), "wk": (kv, h), "wv": (kv, h), "wo": (h, q),
              "w_gate": (f, h), "w_up": (f, h), "w_down": (h, f)}

    def norm():
        return (1 + llama.normal(gen, (h,), 0.1).float()).to(torch.bfloat16)

    hf = {"model.embed_tokens.weight": llama.normal(
              gen, (cfg.vocab_size, h), 0.02),
          "model.norm.weight": norm()}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        hf[pre + "input_layernorm.weight"] = norm()
        hf[pre + "post_attention_layernorm.weight"] = norm()
        for ours, (n, k) in shapes.items():
            hf[pre + _HF_PROJ[ours] + ".weight"] = llama.normal(
                gen, (n, k), 1 / math.sqrt(k))
    return hf


def _same_bits(a, b) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8)))


def _check_loaded(what, got, want):
    """Every leaf of two params trees bit for bit (shapes and dtypes
    too)."""
    bad = []

    def walk(x, y, path):
        if isinstance(y, dict):
            if set(x) != set(y):
                bad.append(path)
                return
            for k in y:
                walk(x[k], y[k], f"{path}.{k}")
        elif isinstance(y, list):
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{path}[{i}]")
        elif not _same_bits(x, y):
            bad.append(path)

    walk(got, want, "params")
    if bad:
        raise AssertionError(f"load {what}: leaves differ from the same "
                             f"params built in memory: {bad[:8]}")


def _run_path(rec, path, run):
    """run() with every kernel's launch count set to 0 just before and
    read just after; fails unless every kernel of PATHS[path] launched.
    Returns (run's result, the launches)."""
    _reset_launches()
    out = run()
    torch.cuda.synchronize()
    launches = _launch_counts()
    missing = [k for k in PATHS[path] if launches[k] == 0]
    if missing:
        raise AssertionError(f"{path}: kernels never launched: {missing} "
                             f"({launches})")
    for name, n in launches.items():
        rec["launches"][name] = rec["launches"].get(name, 0) + n
    return out, launches


def phase_load(rec):
    """models/loader.load_llama on the card: a 2-layer checkpoint at
    Llama-3-8B's widths (vocab 128256, tied embeddings) written by
    _write_safetensors into a temporary directory in two flavours, dense
    bf16 and ModelOpt NVFP4 (each projection quantize_nvfp4'd on the card,
    its scales stored F8_E4M3), each loaded in nvfp4 on the card: every
    leaf bit for bit the same params built in memory (quantize_linear of
    the same weights, or the repack of the same bytes), then loaded again
    through the repack cache, the same bits; then Engine serves 2 prompts
    of 8 tokens over each loaded model and over the in-memory params:
    the same tokens. Both load times printed."""
    rec.setdefault("launches", {})
    _load_flavours(rec, llama.LlamaConfig.llama3_8b(num_layers=2),
                   torch.device("cuda"))


def _load_flavours(rec, cfg, dev):
    """phase_load's work for the model `cfg` on `dev`."""
    hf = _load_checkpoint(cfg, dev)
    embed = hf["model.embed_tokens.weight"]
    base = {"embed": embed, "final_norm": hf["model.norm.weight"],
            "lm_head": {"w": embed.T}}
    config = dict(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
                  intermediate_size=cfg.intermediate_size,
                  num_hidden_layers=cfg.num_layers,
                  num_attention_heads=cfg.num_heads,
                  num_key_value_heads=cfg.num_kv_heads,
                  head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                  rms_norm_eps=cfg.rms_eps, tie_word_embeddings=True,
                  architectures=["LlamaForCausalLM"])
    rng = np.random.default_rng(5)
    reqs = [serving.Request(uid=i, tokens=rng.integers(
        0, cfg.vocab_size, size=n).astype(np.int32), max_new_tokens=8)
        for i, n in enumerate((40, 70))]
    out = {}
    for flavour in ("dense bf16", "ModelOpt NVFP4"):
        layers, tensors = [], dict(hf)
        for i in range(cfg.num_layers):
            pre = f"model.layers.{i}."
            lp = {"attn_norm": hf[pre + "input_layernorm.weight"],
                  "mlp_norm": hf[pre + "post_attention_layernorm.weight"]}
            for ours, name in _HF_PROJ.items():
                key = pre + name
                w = hf[key + ".weight"]
                n, k = w.shape
                if flavour == "dense bf16":
                    lp[ours] = llama.quantize_linear(w.float().T, "nvfp4")
                    continue
                qw, sc, gs = qref.quantize_nvfp4(w.float())
                tensors[key + ".weight"] = qw
                tensors[key + ".weight_scale"] = sc.view(FP8)
                tensors[key + ".weight_scale_2"] = gs.reshape(())
                lp[ours] = {
                    "words": layout.repack_fp4_weights(qw, n, k),
                    "scales": layout.process_fp4_scales(sc, n, k,
                                                        group_size=16),
                    "gs": gs.reshape(()).float()}
            layers.append(lp)
        want = dict(base, layers=layers)
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            _write_safetensors(os.path.join(d, "model.safetensors"), tensors)
            with open(os.path.join(d, "config.json"), "w") as f:
                json.dump(config, f)
            write_s = time.perf_counter() - t0
            nbytes = os.path.getsize(os.path.join(d, "model.safetensors"))
            del tensors
            times = []
            for attempt in ("first", "from the repack cache"):
                gc.collect()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lcfg, got = loader.load_llama(d, "nvfp4", device=dev)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                if lcfg != cfg:
                    raise AssertionError(f"load {flavour}: config {lcfg}")
                if attempt == "first" and not os.path.exists(
                        loader._cache_file(d, "nvfp4")):
                    raise AssertionError(f"load {flavour}: no repack cache")
                _check_loaded(f"{flavour} ({attempt})", got, want)
                if attempt == "first":
                    del got
            free = shutil.disk_usage(d).free
        path = f"load {flavour} checkpoint nvfp4 Engine"
        toks = {}
        for src, params in (("loaded", got), ("in memory", want)):
            eng = serving.Engine(params, cfg, max_batch=2)
            if src == "loaded":
                toks[src], _ = _run_path(rec, path, lambda: eng.run(reqs))
            else:
                toks[src] = eng.run(reqs)
            del eng
        if toks["loaded"] != toks["in memory"]:
            raise AssertionError(f"{path}: tokens {toks['loaded']} differ "
                                 f"from the in-memory params' "
                                 f"{toks['in memory']}")
        out[flavour] = dict(checkpoint_bytes=nbytes, write_s=write_s,
                            load_s=times[0], cached_load_s=times[1],
                            disk_free_bytes=free, tokens=toks["loaded"])
        log(f"[load] {flavour}: {nbytes / 2**30:.2f} GiB checkpoint written "
            f"in {write_s:.2f} s; load_llama(nvfp4) {times[0]:.2f} s, "
            f"again from the repack cache {times[1]:.2f} s, every leaf bit "
            f"for bit the in-memory params both times; Engine tokens equal "
            f"the in-memory params' ({sum(len(v) for v in toks['loaded'].values())} "
            f"tokens)")
        del got, want, layers
    rec["load"] = out


# -- serve_spec: SpecEngine, each tick one replayed CUDA graph ---------------

_DRAFT_MODEL = {}


def _draft_model(dev):
    """Draft (a) of serve_spec: Llama-3-8B's widths at 2 layers, random
    nvfp4 weights from seed 1 (its own embedding and head)."""
    if "params" not in _DRAFT_MODEL:
        dcfg = llama.LlamaConfig.llama3_8b(num_layers=2)
        gen = torch.Generator(device=dev).manual_seed(1)
        _DRAFT_MODEL.update(params=_random_quantized(dcfg, gen), cfg=dcfg)
    return _DRAFT_MODEL["params"], _DRAFT_MODEL["cfg"]


def _count_spec_captures(eng):
    """Give eng its tick buffers now and wrap the tick it captures, so that
    the captured tick of each (g, window) counts its kernel launches (the
    masked warm-up before it is not counted; replays move no counter).
    Returns ({(g, window): {kernel: launches}}, [(g, active slots, their
    n_acc, the tick's wall ms: upload, replay and read) of each
    tick])."""
    eng._ticks = ticks = serving._SpecTicks(eng)
    captured, seen = {}, []
    inner_tick, inner_run = ticks._tick, ticks.run

    def tick(g, window, mask, draw=True):
        before = _launch_counts()
        out = inner_tick(g, window, mask, draw)
        if torch.cuda.is_current_stream_capturing():
            captured[(g, window)] = {k: n - before[k] for k, n in
                                     _launch_counts().items()
                                     if n > before[k]}
        return out

    def run(g, window):
        t0 = time.perf_counter()
        out = inner_run(g, window)
        ms = (time.perf_counter() - t0) * 1e3
        seen.append((g, int(eng.active.sum()), out[eng.active, g + 1], ms))
        return out

    ticks._tick, ticks.run = tick, run
    return captured, seen


def _tie_check(path, eng, reqs, out):
    """Every emitted token against the target's own score_forward logits
    over its prompt and the tokens before it: the token is the argmax, or
    its logit lies within 2^-5 * max|logits| of the top (a near-tie the
    verify's and the scorer's summation orders may break apart). Returns
    (tokens that are the argmax, tokens within the tie band)."""
    seqs = [np.concatenate([r.tokens, np.asarray(out[r.uid], np.int32)])
            for r in reqs]
    L = max(len(s) for s in seqs)
    toks = np.zeros((eng.B, L), np.int32)
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = s
    logits = eng.score_forward(toks)
    exact = tied = 0
    for i, r in enumerate(reqs):
        p, emitted = len(r.tokens), out[r.uid]
        lg = logits[i, p - 1:p - 1 + len(emitted)].float()
        tok = torch.as_tensor(emitted, device=lg.device).long()
        gap = lg.max(-1).values - lg.gather(1, tok[:, None])[:, 0]
        band = 2 ** -5 * lg.abs().max(-1).values
        if bool((gap > band).any()):
            j = int((gap > band).nonzero()[0, 0])
            raise AssertionError(
                f"{path}: request {r.uid} token {j} ({emitted[j]}) is "
                f"{gap[j].item():.4f} below the target's top logit (band "
                f"{band[j].item():.4f})")
        exact += int((gap == 0).sum())
        tied += int(((gap > 0) & (gap <= band)).sum())
    del logits
    return exact, tied


def _spec_replay_check(eng, reqs):
    """After admitting the first max_batch requests: one tick at the depth
    _pick_gamma gives and its window, eagerly (the tick function outside a
    graph, on the current stream) from a snapshot of both caches and the
    generator, then the same tick from the restored snapshot as a replay
    of its (g, window) graph (captured now if new). Returns (outputs
    equal, both caches' bytes equal, g, window, the replay's device
    ms)."""
    eng.reset()
    for r in reqs[:eng.B]:
        eng.add_request(r)
    while eng._pf:
        eng._advance_prefill()
    ticks = eng._ticks
    g = eng._pick_gamma()
    window = eng._tick_window(g)
    kv = [t for pair in eng.cache + eng.dcache for t in pair]
    snap = [t.clone() for t in kv]
    gstate = eng.generator.get_state()
    with torch.inference_mode():
        ticks._upload()
        want = ticks._tick(g, window, ticks.active).cpu().numpy()
    want_kv = [t.view(torch.uint8).clone() for t in kv]
    for t, t0 in zip(kv, snap):
        t.copy_(t0)
    del snap
    eng.generator.set_state(gstate)
    got = ticks.run(g, window)
    same_out = bool((got == want).all())
    same_kv = all(torch.equal(t.view(torch.uint8), w)
                  for t, w in zip(kv, want_kv))
    del want_kv
    graph = ticks.graphs[(g, window)][0]
    ms = cuda_ms(graph.replay, iters=5, warmup=1)
    eng.reset()
    return same_out, same_kv, g, window, ms


def _serve_spec_run(rec, path, make, reqs, cfg, draft_layers, tie=True):
    """A fresh SpecEngine from make() serving `reqs` (its launch counts
    from 0, captures included; PATHS[path] must launch), then the same run
    on the engine whose graphs exist (the same tokens); each captured tick
    must launch its layout's KV append once a layer a draft step and once
    a layer for the verify; with `tie`, every token meets _tie_check;
    then _spec_replay_check. Returns the run's record."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = make()
    captured, seen = _count_spec_captures(eng)
    t0 = time.perf_counter()
    out, launches = _run_path(rec, path, lambda: eng.run(reqs))
    wall = time.perf_counter() - t0
    _check_outputs(path, out, len(reqs), cfg)
    append = ("kv_append_headed" if eng.cache[0][0].dtype == FP8
              else "kv_append")
    for (g, window), counts in captured.items():
        want = g * draft_layers + cfg.num_layers
        if counts.get(append, 0) != want:
            raise AssertionError(f"{path}: the tick captured at g={g} window"
                                 f"={window} launched {append} "
                                 f"{counts.get(append, 0)} times, not {want}")
    ticks = eng._ticks
    stats = dict(eng.spec_stats)
    n_tok = sum(len(v) for v in out.values())
    cap = sum((g - 1) * n for g, n, _, _ in seen)
    slot_ticks = sum(n for _, n, _, _ in seen)
    run = dict(wall_s=wall, new_tokens=n_tok, tok_per_s=n_tok / wall,
               launches=launches, tokens=[out[i] for i in sorted(out)],
               spec_stats=stats, accept_cap=cap, slot_ticks=slot_ticks,
               accepted_per_slot_tick=stats["accepted"] / max(slot_ticks, 1),
               tokens_per_tick=n_tok / max(stats["ticks"], 1),
               gammas=[g for g, _, _, _ in seen],
               graphs=[list(k) for k in sorted(ticks.graphs)],
               capture_s=ticks.capture_s,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches_per_captured_tick={f"g={g} window={w}": c for
                                           (g, w), c in captured.items()})
    eng.reset()
    seen.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = eng.run(reqs)
    torch.cuda.synchronize()
    run["warm_wall_s"] = time.perf_counter() - t0
    run["warm_tok_per_s"] = n_tok / run["warm_wall_s"]
    ticks_ms = {}
    for g, _, _, ms in seen:
        ticks_ms.setdefault(g, []).append(ms)
    run["warm_tick_ms"] = {str(g): float(np.median(v))
                           for g, v in sorted(ticks_ms.items())}
    run["warm_ticks"] = {str(g): len(v) for g, v in sorted(ticks_ms.items())}
    run["forced_n_acc"] = all(bool((acc == g - 1).all())
                              for g, _, acc, _ in seen)
    if again != out:
        raise AssertionError(f"{path}: a second run on the same engine gave "
                             "other tokens")
    if tie:
        run["tie_exact"], run["tie_band"] = _tie_check(path, eng, reqs, out)
    same_out, same_kv, g, window, ms = _spec_replay_check(eng, reqs)
    run.update(replay_check_out=same_out, replay_check_caches=same_kv,
               replay_check_key=[g, window], replay_device_ms=ms,
               graphs_after_check=[list(k) for k in sorted(ticks.graphs)],
               capture_s_total=ticks.capture_s)
    log(f"[{path}] {n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} tok/s "
        f"({len(captured)} tick graphs captured in the run, "
        f"{ticks.capture_s:.2f} s of capture); warm "
        f"{run['warm_tok_per_s']:.1f} tok/s, a tick (upload, replay, read; "
        f"median by g) {run['warm_tick_ms']} ms over "
        f"{run['warm_ticks']} ticks; {stats['ticks']} ticks, "
        f"{stats['accepted']} of {stats['proposed']} drafts accepted (cap "
        f"{cap}, {run['accepted_per_slot_tick']:.2f} a slot a tick), "
        f"{run['tokens_per_tick']:.2f} tokens a tick; depths "
        f"{run['gammas']}; peak device memory {run['peak_gib']:.2f} GiB")
    log(f"[{path}] launches per captured tick: "
        f"{run['launches_per_captured_tick']}")
    if tie:
        log(f"[{path}] every token meets the tie rule against the target's "
            f"score_forward: {run['tie_exact']} the argmax, "
            f"{run['tie_band']} within the band")
    log(f"[{path}] replay check at g={g} window={window}: output "
        f"{'equal' if same_out else 'DIFFERS'}, both caches' bytes "
        f"{'equal' if same_kv else 'DIFFER'}; one replay {ms:.3f} ms")
    if not (same_out and same_kv):
        raise AssertionError(f"{path}: the tick graph's replay is not bit "
                             "for bit the eager tick")
    del eng
    return run


def phase_serve_spec(rec):
    """SpecEngine over serve's 32-layer Llama-3-8B (nvfp4) and the first 4
    of its requests (32 new tokens each, max_batch 4): draft (a) 2 layers
    at the same widths (_draft_model) over bf16 and over fp8 caches, draft
    (b) the target itself over bf16 caches, gamma 11, adaptive; then draft
    (a) with force_accept = 1.0 (n_acc = g - 1 in every tick); beside the
    same requests through Engine.run(decode_block=8) over each cache
    dtype, fresh and warm. Each spec run as _serve_spec_run checks it;
    draft (b) must accept at least half of the cap, (g - 1) a slot a
    tick."""
    dev = torch.device("cuda")
    cfg = llama.LlamaConfig.llama3_8b()
    params, _ = _serve_model(cfg, dev)
    dparams, dcfg = _draft_model(dev)
    reqs = _serve_requests(cfg)[:4]
    rec.setdefault("launches", {})
    out = {}
    for path, dp, dc, dtype, force in (
            ("serve_spec bf16 SpecEngine draft 2-layer", dparams, dcfg,
             torch.bfloat16, 0.0),
            ("serve_spec fp8 SpecEngine draft 2-layer", dparams, dcfg, FP8,
             0.0),
            ("serve_spec bf16 SpecEngine draft = target", params, cfg,
             torch.bfloat16, 0.0),
            ("serve_spec bf16 SpecEngine draft 2-layer force_accept=1",
             dparams, dcfg, torch.bfloat16, 1.0)):
        def make(dp=dp, dc=dc, dtype=dtype, force=force):
            eng = serving.SpecEngine(params, cfg, dp, dc, gamma=11,
                                     max_batch=4, draft_fmt="nvfp4",
                                     cache_dtype=dtype)
            eng.force_accept = force
            return eng

        run = _serve_spec_run(rec, path, make, reqs, cfg, dc.num_layers,
                              tie=force == 0.0)
        if force and not run["forced_n_acc"]:
            raise AssertionError(f"{path}: a tick accepted fewer than g - 1")
        if dp is params and run["spec_stats"]["accepted"] < \
                run["accept_cap"] / 2:
            raise AssertionError(f"{path}: accepted {run['spec_stats']} "
                                 f"below half of the cap {run['accept_cap']}")
        out[path] = run
    for tag, dtype in (("bf16", torch.bfloat16), ("fp8", FP8)):
        path = f"serve_spec {tag} Engine decode_block=8"
        eng = serving.Engine(params, cfg, max_batch=4, cache_dtype=dtype)
        t0 = time.perf_counter()
        got, launches = _run_path(rec, path,
                                  lambda: eng.run(reqs, decode_block=8))
        wall = time.perf_counter() - t0
        _check_outputs(path, got, len(reqs), cfg)
        eng.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(reqs, decode_block=8)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        n_tok = sum(len(v) for v in got.values())
        out[path] = dict(wall_s=wall, tok_per_s=n_tok / wall,
                         warm_tok_per_s=n_tok / warm, launches=launches)
        log(f"[{path}] the same requests: {n_tok / wall:.1f} tok/s fresh, "
            f"{n_tok / warm:.1f} warm")
        del eng
    for path, run in out.items():
        if "SpecEngine" in path:
            tag = "fp8" if " fp8 " in path else "bf16"
            base = out[f"serve_spec {tag} Engine decode_block=8"]
            log(f"[{path}] warm {run['warm_tok_per_s']:.1f} tok/s beside "
                f"Engine.run(decode_block=8) warm "
                f"{base['warm_tok_per_s']:.1f} tok/s on the same requests")
    rec["serve_spec"] = out


# ---------------------------------------------------------------------------
# serve_parallel: tensor and expert parallelism on a one-rank mesh
# ---------------------------------------------------------------------------

# what main() closes on exit: the one-rank process group, once made
_AT_EXIT = contextlib.ExitStack()


def _one_rank_group():
    """A one-rank NCCL process group on cuda:0 over a file store, its
    communicator made at once (device_id), so that it exists before the
    first decode graph is captured. Made at the first call and kept for
    the phases after it (a process starts one default group): main()
    destroys it on exit with the store."""
    if dist.is_initialized():
        return
    store = tempfile.mkdtemp(prefix="pk_nccl_")
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method="file://" + os.path.join(store, "store"),
        world_size=1, rank=0, device_id=torch.device("cuda", 0))

    def destroy():
        gc.collect()
        torch.cuda.synchronize()
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)

    _AT_EXIT.callback(destroy)


def _tp_model(cfg, mesh, dev):
    """The 32-layer Llama-3-8B through parallel.tp.quantize_params_tp on
    the mesh: random dense weights from seed 0 made on the card one layer
    at a time (a generator of layers), unfused nvfp4. At tp = 1 the rank's
    tree is the whole unfused model, which the plain Engine also serves."""
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    dense = llama.init_params(dataclasses.replace(cfg, num_layers=0), gen)
    dense["layers"] = (llama.init_layer(cfg, gen)
                       for _ in range(cfg.num_layers))
    params = tp_mod.quantize_params_tp(dense, cfg, mesh)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def _block_profile(name, eng, reqs, cfg):
    """The first 4 requests admitted with 256 new tokens each (room for
    _whole_trace's retries), 2 eager steps to warm up and 8 on the wall
    clock, one block of 10 to capture its graph, then one block of 10
    under torch.profiler (_whole_trace): eager and block wall ms a step,
    kernel ms, idle share, and the NCCL kernels' share of the kernel
    time."""
    eng.reset()
    for r in reqs[:4]:
        eng.add_request(dataclasses.replace(r, max_new_tokens=256))
    while eng._pf:
        eng._advance_prefill()
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        eng.step()
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / 8
    eng.step_block(10, waiters=False)
    wall, kern, rows = _whole_trace(name, "block_decode", cfg,
                                    lambda: eng.step_block(10,
                                                           waiters=False))
    nccl = [(k, ms, c) for k, ms, c in rows if "nccl" in k.lower()]
    nccl_ms = sum(ms for _, ms, _ in nccl)
    copies = [(k, ms, c) for k, ms, c in rows
              if k.startswith(("Memcpy", "Memset"))]
    eng.reset()
    out = dict(eager_step_ms=eager_ms, step_ms=wall / 10,
               kernel_ms_per_step=kern / 10,
               idle_share=1 - kern / wall,
               nccl_ms_per_step=nccl_ms / 10, nccl_share=nccl_ms / kern,
               nccl_kernels_per_step=sum(c for _, _, c in nccl) / 10,
               nccl_kernels=sorted({k for k, _, _ in nccl}),
               records_per_step=sum(c for _, _, c in rows) / 10,
               copies_per_step={k: (c / 10, ms / 10) for k, ms, c in copies})
    log(f"[{name}] eager step {eager_ms:.2f} ms (wall, 8 steps); a block "
        f"of 10 under the profiler: "
        f"{out['step_ms']:.2f} ms a step (wall), kernels and copies "
        f"{out['kernel_ms_per_step']:.3f} ms in "
        f"{out['records_per_step']:.1f} records, idle "
        f"{100 * out['idle_share']:.1f}%; NCCL "
        f"{out['nccl_kernels_per_step']:.0f} kernels "
        f"{out['nccl_ms_per_step']:.3f} ms a step = "
        f"{100 * out['nccl_share']:.1f}% of the kernel time "
        f"({out['nccl_kernels']}); copies a step (count, ms) "
        f"{out['copies_per_step']}")
    return out


def _collective_host_us(mesh, dev, calls=200):
    """Host microseconds a call of each collective helper of
    parallel/tp.py takes at this world size, eager, on a decode step's
    (4, 1, 4096) bf16 activations and (4, 1, 128256) logits: the wall
    clock over `calls` calls, then a synchronize."""
    x = torch.zeros((4, 1, 4096), dtype=torch.bfloat16, device=dev)
    lg = torch.zeros((4, 1, 128256), dtype=torch.bfloat16, device=dev)
    tp = tp_mod.mesh_axis(mesh, "tp")
    out = {}
    for what, fn in (
            ("all_reduce", lambda: tp_mod.all_reduce(x, tp)),
            ("all_gather logits", lambda: tp_mod.all_gather(lg, tp, 2)),
            ("reduce_scatter", lambda: tp_mod.reduce_scatter(x, tp, 1))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out[what] = (time.perf_counter() - t0) * 1e6 / calls
    log(f"[serve_parallel] host us a call, eager, world of one: "
        + ", ".join(f"{k} {v:.1f}" for k, v in out.items()))
    return out


def _warm_block_run(rec, path, eng, reqs, cfg):
    """eng.run(reqs, decode_block=8) twice (the second with the graphs
    made), counted by _run_path; returns (tokens by uid, fresh and warm
    tokens/s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = _run_path(rec, path, lambda: eng.run(reqs, decode_block=8))
    fresh = time.perf_counter() - t0
    _check_outputs(path, out, len(reqs), cfg)
    eng.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = eng.run(reqs, decode_block=8)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    if again != out:
        raise AssertionError(f"{path}: a second run gave other tokens")
    n_tok = sum(len(v) for v in out.values())
    return [out[i] for i in sorted(out)], n_tok / fresh, n_tok / warm


def _parallel_tp_engines(rec, cfg, mesh, params, reqs):
    """Part 1 of serve_parallel: for the flat bf16 cache (serve's 8
    requests) and the headed fp8 cache (the first 4), the plain Engine
    over the unfused params and the TP Engine
    (make_tp_step, init_cache_tp) over the same tree, eager (_serve) and
    in decode blocks of 8 (_serve_block for the TP Engine, its snapshot
    check included; _warm_block_run and _block_replay_check for the plain
    one); the TP Engine's tokens must be the plain Engine's bit for bit
    in both modes. Then one profiled block of each over bf16."""
    step = tp_mod.make_tp_step(cfg, mesh)
    out = {}
    # the fp8 repeat serves the first 4 requests, to keep the phase short
    for tag, dtype, reqs in (("bf16", torch.bfloat16, reqs),
                             ("fp8", FP8, reqs[:4])):
        def plain(dtype=dtype):
            return serving.Engine(params, cfg, max_batch=4,
                                  cache_dtype=dtype)

        def tp(dtype=dtype):
            return serving.Engine(
                params, cfg, max_batch=4, forward_fn=step,
                cache=tp_mod.init_cache_tp(cfg, 4, mesh, dtype=dtype))

        run_p, eng = _serve(rec, f"serve_parallel {tag} Engine", plain,
                            reqs, cfg)
        del eng
        run_t, eng = _serve(rec, f"serve_parallel {tag} TP Engine", tp,
                            reqs, cfg)
        del eng
        if run_t["tokens"] != run_p["tokens"]:
            raise AssertionError(f"serve_parallel {tag}: the TP Engine's "
                                 "tokens are not the plain Engine's")
        path = f"serve_parallel {tag} TP Engine decode_block=8"
        blk_t = _serve_block(rec, path, tp, reqs, cfg, run_t["tokens"])
        eng = plain()
        toks, fresh, warm = _warm_block_run(
            rec, f"serve_parallel {tag} Engine decode_block=8", eng, reqs,
            cfg)
        same_toks, same_cache, block_ms = _block_replay_check(eng, reqs)
        if not (same_toks and same_cache):
            raise AssertionError(f"serve_parallel {tag} Engine: a block of "
                                 "8 is not bit for bit 8 eager steps")
        if blk_t["tokens"] != toks:
            raise AssertionError(f"{path}: tokens are not the plain "
                                 "Engine's run(decode_block=8) tokens")
        blk_p = dict(tokens=toks, tok_per_s=fresh, warm_tok_per_s=warm,
                     replay_check_block_ms=block_ms)
        log(f"[serve_parallel] {tag}: TP Engine tokens equal the plain "
            f"Engine's, eager and in blocks of 8; eager "
            f"{run_t['tok_per_s']:.1f} against {run_p['tok_per_s']:.1f} "
            f"tok/s; blocks fresh {blk_t['tok_per_s']:.1f} against "
            f"{fresh:.1f}, warm {blk_t['warm_tok_per_s']:.1f} against "
            f"{warm:.1f} tok/s; a block step (8 replays, one read) "
            f"{blk_t['replay_check_block_ms'] / 8:.3f} against "
            f"{block_ms / 8:.3f} ms")
        if tag == "bf16":
            blk_t["profile"] = _block_profile(
                "serve_parallel bf16 TP Engine", tp(), reqs, cfg)
            blk_p["profile"] = _block_profile(
                "serve_parallel bf16 Engine", eng, reqs, cfg)
        del eng
        out[tag] = {"Engine": run_p, "TP Engine": run_t,
                    "TP Engine decode_block=8": blk_t,
                    "Engine decode_block=8": blk_p}
    return out


def _parallel_sp_rs(cfg, mesh, params, dev):
    """Part 2: make_tp_forward_sp against make_tp_forward on one 512-token
    prompt (equal bits at tp = 1), and mul_fp4_tp_rs over layer 0's
    w_down at m = 8 and 512 against mul_nvfp4_a16 on the same bytes (equal
    bits: the reduce-scatter of one rank is a copy); ms of each."""
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, size=(1, 512)), device=dev)
    fwd = tp_mod.make_tp_forward(cfg, mesh)
    fwd_sp = tp_mod.make_tp_forward_sp(cfg, mesh)
    want, got = fwd(params, toks), fwd_sp(params, toks)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs().max().item()
    out = dict(sp_max_abs_diff=diff,
               sp_equal=bool(torch.equal(got.view(torch.int16),
                                         want.view(torch.int16))),
               tp_forward_ms=cuda_ms(lambda: fwd(params, toks), iters=3,
                                     warmup=1),
               sp_forward_ms=cuda_ms(lambda: fwd_sp(params, toks), iters=3,
                                     warmup=1))
    log(f"[serve_parallel] make_tp_forward_sp against make_tp_forward, "
        f"(1, 512) prompt, 32 layers: max abs diff {diff:.3e}, bits "
        f"{'equal' if out['sp_equal'] else 'DIFFER'}; "
        f"{out['sp_forward_ms']:.2f} against {out['tp_forward_ms']:.2f} ms")
    if not out["sp_equal"] or not math.isfinite(diff):
        raise AssertionError("serve_parallel: the SP forward differs from "
                             "the TP forward at tp = 1")
    del want, got
    layer = params["layers"][0]["w_down"]
    k, n = 14336, layer["words"].shape[1]
    gen = torch.Generator(device=dev).manual_seed(7)
    out["rs"] = []
    for m in (8, 512):
        a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        y = tp_mod.mul_fp4_tp_rs(a, layer, mesh, k)
        ref = gemm.mul_nvfp4_a16(a, layer["words"], layer["scales"],
                                 layer["gs"], m, n, k, -1)
        torch.cuda.synchronize()
        if not torch.equal(y.view(torch.int16), ref.view(torch.int16)):
            raise AssertionError(f"serve_parallel: mul_fp4_tp_rs at m = {m} "
                                 "is not mul_nvfp4_a16's bits at tp = 1")
        row = dict(m=m, k=k, n=n,
                   rs_ms=cuda_ms(lambda: tp_mod.mul_fp4_tp_rs(a, layer,
                                                              mesh, k)),
                   gemm_ms=cuda_ms(lambda: gemm.mul_nvfp4_a16(
                       a, layer["words"], layer["scales"], layer["gs"], m,
                       n, k, -1)))
        out["rs"].append(row)
        log(f"[serve_parallel] mul_fp4_tp_rs w_down m={m}: bit for bit "
            f"mul_nvfp4_a16; {row['rs_ms']:.4f} ms against "
            f"{row['gemm_ms']:.4f} ms")
    return out


_UNFUSED_NAMES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _parallel_shard_shapes(dev):
    """Part 3: the shapes a tp = 2 or 4 rank's projections launch, in this
    one process: each Llama-3-8B projection (random, nvfp4) through
    quantize_linear_tp (wo and w_down k-sharded with a per-shard repack),
    each rank's local_linear_tp shard through mul_nvfp4_a16 at m = 8 and
    512: twice the same bits, within the GEMM tolerance of its plain twin
    (fused_mul_reference); the shards' columns side by side, or the sum of
    the k-shards' products, within the same tolerance of the unsharded
    product of the same codes."""
    gen = torch.Generator(device=dev).manual_seed(8)
    any_sid = solution_mod.SolutionId(16, 64)
    rows, err_max = [], 0.0
    for name, (k, n) in zip(_UNFUSED_NAMES, LLAMA8B_UNFUSED_KN):
        shard = "k" if name in ("wo", "w_down") else "n"
        w = llama.normal(gen, (k, n), 1.0 / math.sqrt(k))
        full = llama.quantize_linear(w, "nvfp4")
        acts = {m: torch.randn((m, k), generator=gen, device=dev).to(
            torch.bfloat16) for m in (8, 512)}
        def unsharded(a):
            return gemm.mul_nvfp4_a16(a, full["words"], full["scales"],
                                      full["gs"], a.shape[0], n, k, -1)

        whole = {m: unsharded(a) for m, a in acts.items()}
        whole_ms = {m: cuda_ms(lambda a=a: unsharded(a))
                    for m, a in acts.items()}
        for tp in (2, 4):
            g = tp_mod.quantize_linear_tp(w, tp, shard)
            for m, a in acts.items():
                parts = []
                for t in range(tp):
                    loc = tp_mod.local_linear_tp(g, tp, shard, t)
                    kl = k // tp if shard == "k" else k
                    nl = loc["words"].shape[1]
                    a_l = (a[:, t * kl:(t + 1) * kl].contiguous()
                           if shard == "k" else a)

                    def call(a_l=a_l, loc=loc, kl=kl, nl=nl):
                        return gemm.mul_nvfp4_a16(
                            a_l, loc["words"], loc["scales"], loc["gs"], m,
                            nl, kl, -1)

                    y, again = call(), call()
                    twin = fused.fused_mul_reference(
                        a_l, loc["words"], loc["scales"],
                        loc["gs"].reshape(1), sid=any_sid)
                    what = (f"shard {name} tp={tp} rank={t} m={m} "
                            f"(k, n)=({kl}, {nl})")
                    if not torch.equal(y.view(torch.int16),
                                       again.view(torch.int16)):
                        raise AssertionError(f"{what}: two launches differ")
                    e = _close(what, y, twin, 2 ** -7,
                               2 ** -8 * twin.float().abs().max())
                    sid = gemm.resolve_solution(
                        m, nl, kl, ElementB.NVFP4,
                        hints=solution_mod.default_hints())
                    rows.append(dict(name=name, tp=tp, rank=t, m=m, k=kl,
                                     n=nl, tile=[sid.block_m, sid.block_n],
                                     max_abs_err=e, ms=cuda_ms(call)))
                    err_max = max(err_max, e)
                    parts.append(y)
                total = (torch.cat(parts, dim=1) if shard == "n"
                         else sum(p.float() for p in parts))
                want = whole[m]
                e = _close(f"shards {name} tp={tp} m={m} against the "
                           "unsharded product", total, want, 2 ** -7,
                           2 ** -8 * want.float().abs().max())
                shard_ms = sum(r["ms"] for r in rows[-tp:]) / tp
                for r in rows[-tp:]:
                    r["unsharded_ms"] = whole_ms[m]
                joined = "sum" if shard == "k" else "columns"
                log(f"[serve_parallel] {name} tp={tp} m={m}: {tp} shards "
                    f"(k, n) = ({rows[-1]['k']}, {rows[-1]['n']}) tile "
                    f"{rows[-1]['tile']}, twice the same bits, within "
                    f"tolerance of the twin; their {joined} against the "
                    f"unsharded product err {e:.2e}; {shard_ms:.4f} ms a "
                    f"shard against {whole_ms[m]:.4f} unsharded "
                    f"({shard_ms / whole_ms[m]:.2f}x)")
        del w, full, g
    return dict(rows=rows, max_abs_err=err_max)


def _parallel_ep_engine(rec, dev):
    """Part 4: the 32-layer Mixtral-8x7B of serve_moe (its model, built
    here if serve_moe did not run) on a one-rank ("dp", "ep") mesh:
    place_experts_ep keeps every layer's whole stack at ep = 1, and
    Engine(forward_fn=make_ep_step) serves serve's 8 requests through
    run(decode_block=8) (_serve_block, its snapshot check included); its
    tokens must be the Mixtral Engine's (make_engine_forward) in the same
    mode bit for bit: serve_moe's record when it ran, else a run here."""
    cfg = MIXTRAL_8X7B
    params, _ = _moe_model(cfg, dev)
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("dp", "ep"))
    layers = []
    for lp in params["layers"]:
        ex, router = ep_mod.place_experts_ep(lp["experts"], lp["router"],
                                             mesh)
        layers.append({**lp, "experts": ex, "router": router})
    ep_params = {**params, "layers": layers}
    reqs = _serve_requests(cfg)
    step = ep_mod.make_ep_step(cfg, mesh)
    path = "serve_parallel EP Engine decode_block=8"
    run = _serve_block(rec, path, lambda: serving.Engine(
        ep_params, cfg, max_batch=4, forward_fn=step), reqs, cfg, None)
    want = rec.get("serve_moe", {}).get("decode_block_8", {}).get("tokens")
    source = "serve_moe's run"
    if want is None:
        eng = serving.Engine(params, cfg, max_batch=4,
                             forward_fn=moe.make_engine_forward(cfg))
        want, _, _ = _warm_block_run(
            rec, "serve_parallel Mixtral Engine decode_block=8", eng, reqs,
            cfg)
        source = "a run here"
        del eng
    if run["tokens"] != want:
        raise AssertionError(f"{path}: tokens are not the Mixtral Engine's "
                             f"({source})")
    log(f"[{path}] tokens equal the Mixtral Engine's run(decode_block=8) "
        f"({source}); fresh {run['tok_per_s']:.1f}, warm "
        f"{run['warm_tok_per_s']:.1f} tok/s")
    run["compared_with"] = source
    return run


def _dense_step(forward, copy, toks):
    """forward(copy, toks[:, :-1]) -> logits, _train_loss's next-token
    cross-entropy, loss.backward(); returns the loss."""
    logits = forward(copy, toks[:, :-1])
    logp = torch.log_softmax(logits.float(), -1)
    loss = -logp.gather(-1, toks[:, 1:, None]).mean()
    loss.backward()
    return loss


def _dense_train_run(forward, params, toks):
    """One training step's forward and backward (_dense_step) over a
    _train_copy of params. Returns (loss, {path: gradient}, wall ms, peak
    GiB above what was resident before)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    copy = _train_copy(params)
    t0 = time.perf_counter()
    loss = _dense_step(forward, copy, toks)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    grads = {path: w.grad for path, w in _trainable(copy).items()}
    return loss, grads, ms, peak


def _parallel_train(mesh, dev):
    """Part 5: the dense TP and SP training steps (make_tp_forward and
    make_tp_forward_sp over shard_dense_params at tp = 1, their
    collectives NCCL on one rank) against the plain dense step
    (llama.forward, loss.backward()), on a dense bf16 model at Llama-3-8B's
    widths cut to 2 layers (random weights from seed 0), B = 1, T = 512
    (train's tokens): the loss and every gradient bit for bit; each
    step's forward and backward ms (wall, the second of two runs) and peak
    memory beside the plain step's; a third step under torch.profiler
    (kernel ms, kernels, idle share, the kernels by device time)."""
    cfg = llama.LlamaConfig.llama3_8b(num_layers=2)
    dense = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    toks = _train_tokens(cfg)
    shards = tp_mod.shard_dense_params(dense, mesh)
    runs = {
        "plain": (lambda p, t: llama.forward(p, t, cfg)[0], dense),
        "TP": (tp_mod.make_tp_forward(cfg, mesh, fmt="bf16"), shards),
        "SP": (tp_mod.make_tp_forward_sp(cfg, mesh, fmt="bf16"), shards),
    }
    out, want = {}, None
    for name, (fwd, params) in runs.items():
        _dense_train_run(fwd, params, toks)           # warm
        loss, grads, ms, peak = _dense_train_run(fwd, params, toks)
        if not torch.isfinite(loss) or any(
                g is None or not torch.isfinite(g).all()
                for g in grads.values()):
            raise AssertionError(f"serve_parallel train {name}: the loss or "
                                 "a gradient is missing or not finite")
        copy = _train_copy(params)
        wall, kern, rows = _kernel_profile(
            lambda: _dense_step(fwd, copy, toks))
        del copy
        row = dict(loss=loss.item(), step_ms=ms, peak_gib=peak,
                   profile=dict(wall_ms=wall, kernel_ms=kern,
                                idle_share=1 - kern / wall,
                                kernels=sum(c for _, _, c in rows),
                                top=rows[:8]))
        log(f"[serve_parallel] train {name}: profiled step {wall:.1f} ms, "
            f"kernels {kern:.2f} ms in {row['profile']['kernels']}, idle "
            f"{100 * (1 - kern / wall):.1f}%; top "
            + "; ".join(f"{n[:60]} {t:.2f} ms x{c}" for n, t, c in rows[:6]))
        if want is None:
            want = (loss, grads)
        else:
            same = torch.equal(loss, want[0]) and all(
                torch.equal(g, want[1][k]) for k, g in grads.items())
            row["bit_for_bit_plain"] = same
            if not same:
                worst = max(((g.float() - want[1][k].float()).abs().max()
                             / want[1][k].float().abs().max()).item()
                            for k, g in grads.items())
                raise AssertionError(
                    f"serve_parallel train {name}: loss {loss.item()} "
                    f"against {want[0].item()}, gradients off by up to "
                    f"{worst:.3g} of their max: not the plain step's bits")
        out[name] = row
        del grads
    log("[serve_parallel] dense training step, Llama-3-8B widths, 2 layers, "
        "B=1 T=512: " + "; ".join(
            f"{k} loss {v['loss']:.6f}, {v['step_ms']:.1f} ms, peak "
            f"{v['peak_gib']:.2f} GiB" for k, v in out.items())
        + "; TP and SP loss and every gradient bit for bit the plain step's")
    del dense, shards, runs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_serve_parallel(rec):
    """Tensor and expert parallelism (parallel/tp.py, parallel/ep.py) on
    a one-rank NCCL group: every collective runs through NCCL, inside the
    captured decode graphs too. Part 1 the TP Engine against the plain
    Engine (bf16 and fp8 caches), 2 the SP forward and the reduce-scatter
    GEMM, 3 the per-shard GEMM shapes of tp = 2 and 4, 4 the EP Engine
    against the Mixtral Engine, 5 the dense TP and SP training steps
    against the plain dense step."""
    dev = torch.device("cuda")
    rec.setdefault("launches", {})
    out = {}
    seconds = {}
    _one_rank_group()
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("dp", "tp"))
    cfg = llama.LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params, init_s = _tp_model(cfg, mesh, dev)
    log(f"[serve_parallel] quantize_params_tp (tp = 1) of the 32-layer "
        f"Llama-3-8B in {init_s:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    out.update(init_s=init_s, smi=smi_line(),
               collective_host_us=_collective_host_us(mesh, dev))
    out["tp"] = _parallel_tp_engines(rec, cfg, mesh, params,
                                     _serve_requests(cfg))
    seconds["tp engines"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["sp_rs"] = _parallel_sp_rs(cfg, mesh, params, dev)
    del params
    gc.collect()
    seconds["sp and rs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["shards"] = _parallel_shard_shapes(dev)
    seconds["shards"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["ep"] = _parallel_ep_engine(rec, dev)
    seconds["ep engine"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["train"] = _parallel_train(mesh, dev)
    seconds["train"] = time.perf_counter() - t0
    out["seconds"] = seconds
    log("[serve_parallel] seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()))
    rec["serve_parallel"] = out


def _pp_tie_check(path, params, cfg, prompts, toks):
    """Every token a pipelined decode emitted against the plain cacheless
    llama.forward over the prompt and the tokens before it: the argmax,
    or within 2^-5 * max|logits| of the top (a near-tie that the GEMM's
    rounding at another m breaks apart). Returns (argmax tokens, tokens in
    the band)."""
    T0 = prompts.shape[1]
    with torch.inference_mode():
        logits, _ = llama.forward(params, torch.cat([prompts, toks[:, :-1]],
                                                    1), cfg)
        lg = logits[:, T0 - 1:].float()
        gap = lg.amax(-1) - lg.gather(2, toks.long()[..., None])[..., 0]
        band = 2 ** -5 * lg.abs().amax(-1)
    if bool((gap > band).any()):
        b, j = (gap > band).nonzero()[0].tolist()
        raise AssertionError(
            f"{path}: row {b} token {j} ({int(toks[b, j])}) is "
            f"{gap[b, j].item():.4f} below the top logit (band "
            f"{band[b, j].item():.4f})")
    return int((gap == 0).sum()), int(((gap > 0) & (gap <= band)).sum())


def _pp_decode(step, placed, cache, prompts, n_new):
    """prompts (B, T0) teacher-forced through step, then n_new greedy
    tokens; returns (tokens (B, n_new), wall ms a step of the last
    n_new - 1, the logits of the last step)."""
    B, T0 = prompts.shape
    dev = prompts.device

    def pos(t):
        return torch.full((B,), t, dtype=torch.int32, device=dev)

    for t in range(T0):
        logits, cache = step(placed, cache, prompts[:, t], pos(t))
    toks = [logits.argmax(-1).to(torch.int32)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(n_new - 1):
        logits, cache = step(placed, cache, toks[-1], pos(T0 + t))
        toks.append(logits.argmax(-1).to(torch.int32))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (n_new - 1)
    return torch.stack(toks, 1), ms, logits


def _pp_step_profile(step, placed, cache, tok, p):
    """One PP decode step under torch.profiler (_kernel_profile): wall and
    device ms, device kernels, idle share, and the launches of the FP4
    stream body, the flat decode attention and the KV append."""
    wall, kern, rows = _kernel_profile(lambda: step(placed, cache, tok, p))
    names = {"fp4_stream_kernel": "fp4_stream_kernel",
             "decode_attention": "decode_split_kernel",
             "kv_append": "kv_append_kernel"}
    return dict(wall_ms=wall, kernel_ms=kern, idle_share=1 - kern / wall,
                kernels=sum(c for _, _, c in rows),
                path_kernels={k: sum(c for n, _, c in rows if key in n)
                              for k, key in names.items()},
                top=[(n, ms, c) for n, ms, c in rows[:6]])


def _pp_decodes(rec, cfg, mesh, params, placed, reqs):
    """make_pp_step at each PP_MICRO on B = 4: the first 32 tokens of the
    first 4 requests teacher-forced, then 32 greedy tokens, every token
    under _pp_tie_check and counted against greedy_decode's; launches a
    step; ms a step; one step profiled."""
    B, T0, n_new = 4, 32, 32
    dev = placed["embed"].device
    prompts = torch.as_tensor(np.stack([r.tokens[:T0] for r in reqs[:B]]),
                              device=dev)
    greedy = llama.greedy_decode(params, cfg, prompts, n_new)
    out = {}
    for n_micro in PP_MICRO:
        path = f"serve_pp PP decode n_micro={n_micro}"
        step = pp_mod.make_pp_step(cfg, mesh, n_micro, fmt="nvfp4")
        cache = pp_mod.init_cache_pp(cfg, B, mesh)
        (toks, ms, _), launches = _run_path(
            rec, path, lambda: _pp_decode(step, placed, cache, prompts,
                                          n_new))
        steps = T0 + n_new - 1
        per_step = {k: v / steps for k, v in launches.items() if v}
        want = {"kv_append": cfg.num_layers * n_micro,
                "decode_attention": cfg.num_layers * n_micro,
                "fp4_gemm": 4 * cfg.num_layers * n_micro}
        if any(per_step.get(k) != v for k, v in want.items()):
            raise AssertionError(f"{path}: launches a step {per_step}, "
                                 f"expected {want}")
        exact, tied = _pp_tie_check(path, params, cfg, prompts, toks)
        same = int((toks == greedy).sum())
        prof = _pp_step_profile(step, placed, cache, toks[:, -1],
                                torch.full((B,), T0 + n_new - 1,
                                           dtype=torch.int32, device=dev))
        out[n_micro] = dict(step_ms=ms, launches_per_step=per_step,
                            argmax_tokens=exact, tied_tokens=tied,
                            tokens_equal_to_greedy_decode=same,
                            tokens=toks.tolist(), profile=prof)
        log(f"[{path}] {ms:.2f} ms a step (eager wall, {n_new - 1} steps); "
            f"{exact} of {toks.numel()} tokens the plain forward's argmax, "
            f"{tied} within the tie band, {same} equal to greedy_decode's; "
            f"one step profiled: {prof['kernel_ms']:.2f} ms of kernels in "
            f"{prof['kernels']} kernels, idle "
            f"{100 * prof['idle_share']:.1f}%, path kernels "
            f"{prof['path_kernels']}")
        del cache
    return out


def _pp_forward(rec, cfg, mesh, params, placed):
    """make_pp_forward (n_micro 2) on (4, 128) seeded tokens against the
    cacheless llama.forward, within the GEMM tolerance (rtol 2^-7, atol
    2^-8 * max|logits|)."""
    dev = placed["embed"].device
    toks = torch.as_tensor(np.random.default_rng(11).integers(
        0, cfg.vocab_size, size=(4, 128)), device=dev)
    fwd = pp_mod.make_pp_forward(cfg, mesh, 2, fmt="nvfp4")
    path = "serve_pp PP forward"
    got, _ = _run_path(rec, path, lambda: fwd(placed, toks))
    with torch.inference_mode():
        want, _ = llama.forward(params, toks, cfg)
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    _close(path, got, want, 2 ** -7, 2 ** -8 * top)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwd(placed, toks)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    log(f"[{path}] (4, 128) tokens, n_micro 2: max abs err {err:.4g} "
        f"against the plain forward (max |logit| {top:.3f}), bit for bit "
        f"{torch.equal(got, want)}; {ms:.1f} ms")
    return dict(max_abs_err=err, max_logit=top, ms=ms,
                bit_for_bit=torch.equal(got, want))


def _fallback_engine(rec, cfg, params, reqs):
    """Engine(forward_fn=f), f = llama.forward at kv_window = max_seq_len
    taking neither kv_window nor write_mask, serving the first 4 requests
    eager (_serve) and through run(decode_block=8) (_serve_block, its
    snapshot check bit for bit included; one graph, no window key): every
    token within the tie rule of the plain Engine's score_forward
    (_tie_check), and counted against the plain Engine's tokens."""
    def fallback(p, t, c, q):
        return llama.forward(p, t, cfg, c, q, kv_window=cfg.max_seq_len)

    def make():
        eng = serving.Engine(params, cfg, max_batch=4, forward_fn=fallback)
        if eng._admission_batchable() or eng._kv_window() is not None:
            raise AssertionError("serve_pp: the fallback Engine batches "
                                 "admissions or passes a window")
        return eng

    reqs = reqs[:4]
    scorer = serving.Engine(params, cfg, max_batch=4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = scorer.run(reqs)
    torch.cuda.synchronize()
    plain_tok_s = sum(len(v) for v in plain.values()) / (
        time.perf_counter() - t0)
    scorer.reset()
    path = "serve_pp fallback Engine"
    run, eng = _serve(rec, path, make, reqs, cfg)
    del eng
    blk = _serve_block(rec, f"{path} decode_block=8", make, reqs, cfg,
                       run["tokens"])
    if blk["graphs"] != [None]:
        raise AssertionError(f"{path}: decode block graphs {blk['graphs']}, "
                             "expected one without a window")
    out = {"eager": run, "decode_block=8": blk,
           "plain_engine_tok_per_s": plain_tok_s}
    log(f"[{path}] eager {run['tok_per_s']:.1f} tok/s against the plain "
        f"Engine's {plain_tok_s:.1f} on the same requests (eager, fresh)")
    for mode in ("eager", "decode_block=8"):
        r = out[mode]
        toks = {i: t for i, t in enumerate(r["tokens"])}
        r["argmax_tokens"], r["tied_tokens"] = _tie_check(
            f"{path} {mode}", scorer, reqs, toks)
        r["tokens_equal_to_plain_engine"] = sum(
            a == b for i in toks for a, b in zip(toks[i], plain[i]))
        log(f"[{path} {mode}] {r['argmax_tokens']} tokens the plain "
            f"Engine's score_forward argmax, {r['tied_tokens']} within the "
            f"tie band, {r['tokens_equal_to_plain_engine']} of "
            f"{r['new_tokens']} equal to the plain Engine's")
    del scorer
    return out


def phase_serve_pp(rec):
    """Pipeline parallelism (parallel/pp.py) on the one-rank NCCL group at
    pp = 1, and the Engine's fallback for a forward_fn without kv_window
    and write_mask. serve's Llama-3-8B (nvfp4) cut to its first PP_DEPTH
    layers through place_params_pp on a ("dp", "pp") mesh of shape (1, 1):
    make_pp_step at n_micro 1, 2 and 4 (_pp_decodes), make_pp_forward
    (_pp_forward); then the fallback Engine over serve's whole model
    (_fallback_engine)."""
    dev = torch.device("cuda")
    rec.setdefault("launches", {})
    cfg = llama.LlamaConfig.llama3_8b()
    params, _ = _serve_model(cfg, dev)
    reqs = _serve_requests(cfg)
    _one_rank_group()
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("dp", "pp"))
    pcfg = dataclasses.replace(cfg, num_layers=PP_DEPTH)
    pparams = {**params, "layers": params["layers"][:PP_DEPTH]}
    seconds = {}
    t0 = time.perf_counter()
    placed = pp_mod.place_params_pp(pparams, mesh)
    torch.cuda.synchronize()
    out = dict(smi=smi_line(), place_s=time.perf_counter() - t0,
               layers=PP_DEPTH)
    out["decode"] = _pp_decodes(rec, pcfg, mesh, pparams, placed, reqs)
    seconds["pp decode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["forward"] = _pp_forward(rec, pcfg, mesh, pparams, placed)
    del placed
    gc.collect()
    torch.cuda.empty_cache()
    seconds["pp forward"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["fallback"] = _fallback_engine(rec, cfg, params, reqs)
    seconds["fallback engine"] = time.perf_counter() - t0
    out["seconds"] = seconds
    log("[serve_pp] seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()))
    rec["serve_pp"] = out


# ---------------------------------------------------------------------------
# serve_cluster: the cluster tier
# ---------------------------------------------------------------------------

# the layers the cluster phase's children build at Llama-3-8B widths
CLUSTER_DEPTH = 2


def _replica_launches(eng, counts: dict) -> None:
    """Wrap eng.step and eng.step_block so that the kernel launches made
    inside them (outermost calls only: step_block may call step) add to
    `counts`."""
    depth = [0]
    for name in ("step", "step_block"):
        inner = getattr(eng, name)

        def counted(*a, _inner=inner, **kw):
            before = _launch_counts() if depth[0] == 0 else None
            depth[0] += 1
            try:
                return _inner(*a, **kw)
            finally:
                depth[0] -= 1
                if before is not None:
                    for k, n in _launch_counts().items():
                        counts[k] += n - before[k]

        setattr(eng, name, counted)


def _tie_check_all(path, scorer, reqs, out):
    """_tie_check over every request, scorer.B at a time; the summed
    (argmax tokens, tied tokens)."""
    exact = tied = 0
    for i in range(0, len(reqs), scorer.B):
        e, t = _tie_check(path, scorer, reqs[i:i + scorer.B], out)
        exact, tied = exact + e, tied + t
    return exact, tied


def _timed_run(make_cluster, reqs, block):
    """One Cluster.run of `reqs` at decode_block=block, on the card's
    clock: (the cluster, its tokens, wall seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cl = make_cluster()
    out = cl.run(reqs, decode_block=block)
    torch.cuda.synchronize()
    return cl, out, time.perf_counter() - t0


def _cluster_inprocess(rec, cfg, params, reqs):
    """(a) Cluster of two Engine(max_batch=4) over serve's model: each
    decode_block twice, launches counted a replica in the first run, the
    tie rule over every token, tokens/s beside an 8-slot Engine."""
    engines = [serving.Engine(params, cfg, max_batch=4) for _ in range(2)]
    per = [dict.fromkeys(KERNELS, 0) for _ in engines]
    for eng, counts in zip(engines, per):
        _replica_launches(eng, counts)
    scorer = serving.Engine(params, cfg, max_batch=4)
    n_tok = len(reqs) * 32
    out = {}
    for block in (1, 8):
        path = f"serve_cluster in-process Cluster decode_block={block}"
        runs = []
        for _ in range(2):
            for counts in per:
                counts.update(dict.fromkeys(KERNELS, 0))
            _reset_launches()
            cl, toks, wall = _timed_run(
                lambda: cluster_mod.Cluster(engines), reqs, block)
            launches = _launch_counts()
            _check_outputs(path, toks, len(reqs), cfg)
            if cl.failures or cl.transients or cl.replayed:
                raise AssertionError(f"{path}: failures {cl.failures}, "
                                     f"transients {cl.transients}")
            runs.append(dict(wall_s=wall, tok_per_s=n_tok / wall,
                             tokens=[toks[i] for i in sorted(toks)],
                             launches=launches,
                             replica_launches=[dict(c) for c in per]))
        del cl
        first, second = runs
        for i, counts in enumerate(first["replica_launches"]):
            missing = [k for k in PATHS[path] if counts[k] == 0]
            if missing:
                raise AssertionError(f"{path}: replica {i} never launched "
                                     f"{missing} ({counts})")
        for name, n in first["launches"].items():
            rec["launches"][name] = rec["launches"].get(name, 0) + n
        if second["tokens"] != first["tokens"]:
            raise AssertionError(f"{path}: a second run gave other tokens")
        toks = dict(enumerate(first["tokens"]))
        exact, tied = _tie_check_all(path, scorer, reqs, toks)
        out[f"decode_block={block}"] = dict(
            fresh=first, warm_tok_per_s=second["tok_per_s"],
            warm_wall_s=second["wall_s"], argmax_tokens=exact,
            tied_tokens=tied)
        log(f"[{path}] {first['tok_per_s']:.1f} tok/s fresh, "
            f"{second['tok_per_s']:.1f} warm (bit for bit); {exact} tokens "
            f"the plain Engine's score_forward argmax, {tied} in the tie "
            f"band; launches a replica (first run) "
            + "; ".join(f"replica {i}: " + ", ".join(
                f"{k} {c[k]}" for k in PATHS[path])
                for i, c in enumerate(first["replica_launches"])))
    del engines
    gc.collect()
    big = serving.Engine(params, cfg, max_batch=8)
    single = []
    for _ in range(2):
        big.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = big.run(reqs, decode_block=8)
        torch.cuda.synchronize()
        single.append(n_tok / (time.perf_counter() - t0))
    exact, tied = _tie_check_all("serve_cluster Engine(max_batch=8)", scorer,
                                 reqs, toks)
    out["engine_max_batch_8"] = dict(tok_per_s=single[0],
                                     warm_tok_per_s=single[1],
                                     argmax_tokens=exact, tied_tokens=tied)
    blk = out["decode_block=8"]
    log(f"[serve_cluster] decode_block=8: two 4-slot replicas "
        f"{blk['fresh']['tok_per_s']:.1f} tok/s fresh, "
        f"{blk['warm_tok_per_s']:.1f} warm; one Engine(max_batch=8) "
        f"{single[0]:.1f} fresh, {single[1]:.1f} warm (ratio warm "
        f"{blk['warm_tok_per_s'] / single[1]:.3f})")
    del big, scorer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _library_files() -> dict:
    """The kernel build directory's files and their mtimes."""
    return {p.name: p.stat().st_mtime_ns for p in _build.BUILD_DIR.iterdir()}


def _cluster_subprocess(cfg, reqs, reps, local):
    """(b) subprocess replicas `reps`, each up: the pipe bit for bit
    `local`, an in-process Engine over the params of the same spec, a
    crash replayed and revived, a transient fault, ping times."""
    out = {}
    for block in (1, 8):
        _, want, _ = _timed_run(lambda: cluster_mod.Cluster([local]), reqs,
                                block)
        _, got, wall = _timed_run(lambda: cluster_mod.Cluster([reps[0]]),
                                  reqs, block)
        if got != want:
            raise AssertionError(
                f"serve_cluster: the pipe at decode_block={block} gave "
                "other tokens than the in-process Engine")
        out[f"pipe decode_block={block}"] = dict(
            wall_s=wall, tok_per_s=len(reqs) * 32 / wall)
    exact, tied = _tie_check_all("serve_cluster subprocess replica", local,
                                 reqs, want)
    # crash child 0 after the first tick
    cl = cluster_mod.Cluster(reps, probe_cooldown=1)
    cl.submit(reqs)
    cl.tick()
    t_crash = time.perf_counter()
    reps[0].crash()
    revived_s = None
    while True:
        left = cl.tick()
        if revived_s is None and 0 in cl.revived:
            revived_s = time.perf_counter() - t_crash
        if not left:
            break
    crashed = dict(cl.finished)
    _check_outputs("serve_cluster crash", crashed, len(reqs), cfg)
    if not (cl.failures and cl.failures[0][0] == 0 and cl.replayed
            and reps[0].respawns >= 1 and 0 in cl.revived
            and reps[0].ping()):
        raise AssertionError(
            f"serve_cluster crash: failures {cl.failures}, replayed "
            f"{cl.replayed}, respawns {reps[0].respawns}, revived "
            f"{cl.revived}")
    c_exact, c_tied = _tie_check_all("serve_cluster crash", local, reqs,
                                     crashed)
    out["crash"] = dict(
        failures=[i for i, _ in cl.failures], replayed=cl.replayed,
        revived=cl.revived, respawns=reps[0].respawns,
        crash_to_revival_s=revived_s, argmax_tokens=c_exact,
        tied_tokens=c_tied, tokens_equal_to_pipe=sum(
            a == b for u in want for a, b in zip(want[u], crashed[u])))
    # a transient fault keeps the process
    rep, pid = reps[1], reps[1]._procs[0].pid
    cl = cluster_mod.Cluster([rep])
    cl.submit(reqs[:4])
    cl.tick()
    rep.inject_fault("paged KV pool exhausted")
    while cl.tick():
        pass
    if not (cl.transients and not cl.failures and rep.respawns == 0
            and rep._procs[0].pid == pid):
        raise AssertionError(
            f"serve_cluster transient: transients {cl.transients}, "
            f"failures {cl.failures}, respawns {rep.respawns}")
    _tie_check_all("serve_cluster transient", local, reqs[:4],
                   dict(cl.finished))
    out["transient"] = dict(replayed=cl.replayed, respawns=rep.respawns)
    pings = []
    for _ in range(100):
        t = time.perf_counter()
        rep.ping()
        pings.append(time.perf_counter() - t)
    out["ping_us_median"] = float(np.median(pings)) * 1e6
    out.update(argmax_tokens=exact, tied_tokens=tied)
    log(f"[serve_cluster] subprocess replicas ({CLUSTER_DEPTH} layers): the "
        f"pipe bit for bit the in-process Engine at decode_block=1 and 8; "
        f"crash -> revival {revived_s:.2f} s, replayed "
        f"{out['crash']['replayed']}; transient fault kept the process; "
        f"ping round trip {out['ping_us_median']:.1f} us (median of 100)")
    return out


def _cluster_tp_params(cfg, spec):
    """spec's dense weights, made on the card and copied to the host (what
    make_tp_cluster writes to its file), and the plain Engine's unfused
    tree of them on the card (quantize_params_tp at tp = 1 on the
    one-rank group)."""
    dense = rpc.dense_params(spec, torch.device("cuda"))
    dense["layers"] = list(dense["layers"])
    _one_rank_group()
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("dp", "tp"))
    unfused = tp_mod.quantize_params_tp(dense, cfg, mesh)
    return rpc._tree_to(dense, "cpu"), unfused


def _cluster_tp(cfg, reqs, cl, unfused):
    """(c) the TP cluster `cl`, up: every token within the tie rule of the
    plain Engine over `unfused`."""
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = cl.run(reqs, decode_block=8)
    wall = time.perf_counter() - t1
    _check_outputs("serve_cluster TP cluster", got, len(reqs), cfg)
    if cl.failures or cl.transients:
        raise AssertionError(f"serve_cluster TP cluster: {cl.failures}")
    scorer = serving.Engine(unfused, cfg, max_batch=4)
    exact, tied = _tie_check_all("serve_cluster TP cluster", scorer, reqs,
                                 got)
    plain = scorer.run(reqs, decode_block=8)
    same = sum(a == b for u in plain for a, b in zip(plain[u], got[u]))
    log(f"[serve_cluster] make_tp_cluster(dp=2, tp=1): "
        f"{len(reqs) * 32 / wall:.1f} tok/s; {exact} tokens the plain "
        f"Engine's argmax, {tied} in the tie band, {same} equal to the plain "
        "Engine's run")
    del scorer
    gc.collect()
    torch.cuda.empty_cache()
    return dict(wall_s=wall, tok_per_s=len(reqs) * 32 / wall,
                argmax_tokens=exact, tied_tokens=tied,
                tokens_equal_to_plain=same)


def phase_serve_cluster(rec):
    """The cluster tier: (a) _cluster_inprocess over serve's 32-layer
    Llama-3-8B; then four children start together, the TP cluster's two
    ranks and two SubprocessReplicas, each building the model at
    CLUSTER_DEPTH layers (the replicas from seed 0, the ranks from the
    same weights in make_tp_cluster's file): (b) _cluster_subprocess, (c)
    _cluster_tp. No child may rebuild or rewrite the kernel library."""
    dev = torch.device("cuda")
    rec.setdefault("launches", {})
    cfg = llama.LlamaConfig.llama3_8b()
    params, _ = _serve_model(cfg, dev)
    reqs = _serve_requests(cfg)
    out, seconds = dict(smi=smi_line()), {}
    t0 = time.perf_counter()
    out["inprocess"] = _cluster_inprocess(rec, cfg, params, reqs)
    seconds["in-process cluster"] = time.perf_counter() - t0
    cut = llama.LlamaConfig.llama3_8b(num_layers=CLUSTER_DEPTH)
    spec = dict(cfg=dataclasses.asdict(cut), seed=0, fmt="nvfp4",
                max_batch=4)
    before = _library_files()
    dense, unfused = _cluster_tp_params(cut, spec)
    local = serving.Engine(rpc.replica_params(spec), cut, max_batch=4,
                           fmt="nvfp4")
    # the children need the card memory this process has cached
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    t0 = time.perf_counter()
    tp_cl = subs = None
    try:
        # four children start together: the TP cluster's two (after its
        # params file is written) and two SubprocessReplicas
        tp_cl = cluster_mod.make_tp_cluster(dense, cut, dp=2, tp=1,
                                            max_batch=4)
        write_s = time.perf_counter() - t0
        subs = cluster_mod.Cluster([rpc.SubprocessReplica(spec)
                                    for _ in range(2)])
        ready = []
        for r in tp_cl.replicas + subs.replicas:
            if not r.ping():
                raise AssertionError("serve_cluster: a child never "
                                     "answered")
            ready.append(time.perf_counter() - t0)
        out["children"] = dict(tp_params_write_s=write_s,
                               start_to_first_ping_s=ready,
                               card_free_gib=free / 2**30)
        log(f"[serve_cluster] four children started together, "
            f"make_tp_cluster's two ranks (its params file written in "
            f"{write_s:.2f} s first), then two SubprocessReplicas: start to "
            "first ping " + ", ".join(f"{x:.2f}" for x in ready) + " s "
            f"({free / 2**30:.1f} of {total / 2**30:.1f} GiB of the card "
            "free before)")
        seconds["children up"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["subprocess"] = _cluster_subprocess(cut, reqs, subs.replicas,
                                                local)
        seconds["subprocess replicas"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["tp_cluster"] = _cluster_tp(cut, reqs, tp_cl, unfused)
        seconds["tp cluster"] = time.perf_counter() - t0
    finally:
        for c in (subs, tp_cl):
            if c is not None:
                c.shutdown()
    del dense, unfused, local
    after = _library_files()
    if after != before:
        raise AssertionError(f"serve_cluster: the children changed the "
                             f"kernel build directory: {before} -> {after}")
    out["seconds"] = seconds
    log(f"[serve_cluster] {out['smi']}; the kernel library untouched by "
        "the children; seconds by part: " + ", ".join(
            f"{k} {v:.1f}" for k, v in seconds.items()))
    rec["serve_cluster"] = out


def _kernel_profile(steps):
    """Run steps() under torch.profiler; returns (wall ms, summed device ms
    of every kernel, [(kernel name, device ms, calls)] by time)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    return wall, sum(r[1] for r in rows), rows


def _whole_trace(name, what, cfg, ten_steps, tries=3):
    """_kernel_profile of ten decode steps, checked against the profiler
    losing records: each step appends once a layer, so the trace must hold
    10 * num_layers kv_append_kernel records (a lossy trace once held 80%
    of every kernel's records, so its kernels a step read 80% of the
    launch counters'). Profiles up to `tries` times, then fails."""
    want = 10 * cfg.num_layers
    for _ in range(tries):
        prof = _kernel_profile(ten_steps)
        got = sum(c for k, _, c in prof[2] if "kv_append_kernel" in k)
        if got == want:
            return prof
        log(f"[profile] {name} {what}: the trace holds {got} of the "
            f"{want} appends; profiling again")
    raise AssertionError(f"profile {name} {what}: the trace lost records "
                         f"({got} of {want} appends)")


def _profile_engine(name, eng, cfg, chunk=256, decode=True, block=False):
    """Three slots decoding after 200-token prompts, then one tick that
    prefills a `chunk`-token prompt beside them (one chunk, if the engine's
    prefill_chunk allows), then, with `decode`, decode steps of all 4: 20
    on the wall clock, 10 under torch.profiler; then, with `block`, decode
    blocks of all 4 (step_block(10, waiters=False), each step a replay of
    the captured step graph): one block to capture, 2 on the wall clock, 1
    under torch.profiler."""
    rng = np.random.default_rng(3)

    def request(uid, n):
        return serving.Request(uid=uid, tokens=rng.integers(
            0, cfg.vocab_size, size=n).astype(np.int32), max_new_tokens=256)

    for uid in range(3):
        eng.add_request(request(uid, 200))
    while not eng.active[:3].all():
        eng.step()
    eng.add_request(request(3, chunk))
    out = {}

    def report(what, n_steps, prof, keep=15):
        wall, kern, rows = prof
        copies = sum(c for k, _, c in rows if k.startswith(("Memcpy",
                                                             "Memset")))
        kernels = sum(c for _, _, c in rows) - copies
        out[what] = dict(steps=n_steps, wall_ms=wall, kernel_ms=kern,
                         idle_share=1 - kern / wall,
                         kernels_per_step=kernels / n_steps,
                         copies_per_step=copies / n_steps,
                         top=[dict(kernel=k, ms=ms, calls=c)
                              for k, ms, c in rows[:keep]])
        log(f"[profile] {name} {what}: {n_steps} step(s) {wall:.1f} ms "
            f"wall, kernels {kern:.1f} ms, idle "
            f"{100 * (1 - kern / wall):.1f}%; {kernels / n_steps:.1f} device "
            f"kernels and {copies / n_steps:.1f} copies a step")
        for k, ms, c in rows[:15]:
            log(f"[profile]   {ms:9.2f} ms {c:6d}x  {k[:100]}")

    # the chunk, then the decode step of the 3 running slots
    report("prefill_tick", 1, _kernel_profile(eng.step))
    if not eng.active.all():
        raise AssertionError(f"profile {name}: a slot is not decoding")
    if not decode:
        return out
    for _ in range(2):                                   # warm-up
        eng.step()
    torch.cuda.synchronize()
    before = _launch_counts()
    t0 = time.perf_counter()
    for _ in range(20):
        eng.step()
    torch.cuda.synchronize()
    out["decode_step_ms"] = (time.perf_counter() - t0) * 1e3 / 20
    out["launches_per_decode_step"] = {
        k: (n - before[k]) / 20 for k, n in _launch_counts().items()
        if n > before[k]}
    log(f"[profile] {name} launches per decode step: "
        f"{out['launches_per_decode_step']}")
    log(f"[profile] {name} decode step, 4 active slots: "
        f"{out['decode_step_ms']:.2f} ms (wall, 20 steps)")
    # with `block`, every kernel and copy of the eager step is kept, to
    # set beside the block's
    report("decode", 10, _whole_trace(
        name, "decode", cfg, lambda: [eng.step() for _ in range(10)]),
        keep=100 if block else 15)
    if not block:
        return out
    captured = _count_captures(eng)
    eng.step_block(10, waiters=False)                    # captures
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        eng.step_block(10, waiters=False)
    torch.cuda.synchronize()
    out["block_step_ms"] = (time.perf_counter() - t0) * 1e3 / 20
    out["launches_per_captured_step"] = {str(w): c
                                         for w, c in captured.items()}
    log(f"[profile] {name} launches per captured step (counted at capture: "
        f"a replay moves no counter): {out['launches_per_captured_step']}")
    log(f"[profile] {name} block decode step, 4 active slots: "
        f"{out['block_step_ms']:.2f} ms (wall, 2 blocks of 10)")
    # the host's share of a block: enqueueing it (uploads, 10 replays, the
    # copies, the event), waiting for its tokens, absorbing them
    t0 = time.perf_counter()
    blk = eng._run_decode_block(eng.last_tok, eng.pos, 10)
    t1 = time.perf_counter()
    toks = eng._read_block(blk)
    t2 = time.perf_counter()
    eng._absorb_block(toks, 10)
    t3 = time.perf_counter()
    out["block_host_ms"] = dict(enqueue=(t1 - t0) * 1e3,
                                wait=(t2 - t1) * 1e3, absorb=(t3 - t2) * 1e3)
    log(f"[profile] {name} a block of 10 on the host: enqueue "
        f"{(t1 - t0) * 1e3:.2f} ms, wait for its tokens "
        f"{(t2 - t1) * 1e3:.2f} ms, absorb {(t3 - t2) * 1e3:.2f} ms")
    report("block_decode", 10, _whole_trace(
        name, "block_decode", cfg,
        lambda: eng.step_block(10, waiters=False)), keep=100)
    if eng.active.sum() != 4:
        raise AssertionError(f"profile {name}: a slot finished in a block")
    return out


def _profile_train_step(params, cfg):
    """One step of phase train's training (after one step of warm-up) under
    torch.profiler."""
    toks = _train_tokens(cfg)
    tparams = _train_copy(params)
    _train_step(tparams, toks, cfg)
    wall, kern, rows = _kernel_profile(lambda: _train_step(tparams, toks,
                                                           cfg))
    del tparams
    torch.cuda.empty_cache()
    log(f"[profile] train step (B=1, T={toks.shape[1] - 1}): {wall:.1f} ms "
        f"wall, kernels {kern:.1f} ms, idle {100 * (1 - kern / wall):.1f}%")
    for k, ms, c in rows[:15]:
        log(f"[profile]   {ms:9.2f} ms {c:6d}x  {k[:100]}")
    return dict(wall_ms=wall, kernel_ms=kern, idle_share=1 - kern / wall,
                top=[dict(kernel=k, ms=ms, calls=c) for k, ms, c in rows[:15]])


def phase_profile(rec):
    """The serve phase's model in Engine (flat bf16 cache), in Engine over
    the headed fp8 cache and in PagedEngine (fp8 pool, page size 16), its
    hybrid quantization in the
    hybrid Engine, and serve_moe's Mixtral in its Engine, 4 slots each
    (_profile_engine; all but the hybrid Engine also in decode blocks,
    each step a graph replay); one training step of phase train; then a
    512-token
    prefill tick of the Llama Engine with nvfp4 and with W4A8 prefill
    GEMMs, and of the hybrid Engine. Device idle share = 1 - (summed
    kernel time) / wall; device kernels a step = the profiler's kernel
    events (memory copies and sets apart) over the steps."""
    dev = torch.device("cuda")
    cfg = llama.LlamaConfig.llama3_8b()
    params, _ = _serve_model(cfg, dev)
    out = _profile_engine("bf16 Engine", serving.Engine(params, cfg,
                                                        max_batch=4), cfg,
                          block=True)
    gc.collect()
    out["headed_fp8"] = _profile_engine(
        "fp8 Engine", serving.Engine(params, cfg, max_batch=4,
                                     cache_dtype=FP8), cfg, block=True)
    gc.collect()
    out["paged_fp8"] = _profile_engine(
        "fp8 PagedEngine", serving.PagedEngine(params, cfg, max_batch=4,
                                               page_size=16,
                                               cache_dtype=FP8), cfg,
        block=True)
    gc.collect()
    hparams, _ = _hybrid_model(cfg, dev)
    out["hybrid"] = _profile_engine(
        "hybrid Engine", serving.Engine(hparams, cfg, max_batch=4,
                                        fmt="hybrid"), cfg)
    gc.collect()
    out["train_step"] = _profile_train_step(params, cfg)
    gc.collect()
    mcfg = MIXTRAL_8X7B
    mparams, _ = _moe_model(mcfg, dev)
    out["mixtral"] = _profile_engine(
        "Mixtral Engine", serving.Engine(
            mparams, mcfg, max_batch=4,
            forward_fn=moe.make_engine_forward(mcfg)), mcfg, block=True)
    gc.collect()
    # one 512-token prefill tick, exact nvfp4 GEMMs against W4A8 ones, and
    # the hybrid Engine's (its 64-row tiles: both CTA kinds of the hybrid
    # GEMM)
    for tag, p, kw in (("nvfp4", params, dict(prefill_chunk=512)),
                       ("w4a8", params, dict(prefill_fmt="w4a8")),
                       ("hybrid", hparams, dict(prefill_chunk=512,
                                                fmt="hybrid"))):
        out[f"prefill_512_{tag}"] = _profile_engine(
            f"bf16 Engine, {tag} prefill", serving.Engine(
                p, cfg, max_batch=4, **kw), cfg, chunk=512, decode=False)
        gc.collect()
    rec["profile"] = out


def _beside_parent(rec, path):
    """Put the parent run's time of each kernel row beside this run's
    (parent_ms) and log the ratio: an A/B call runs parent, change,
    change, parent, each with --record, the change with --parent-record
    of the run before it."""
    with open(path) as f:
        parent = json.load(f).get("kernels", {})
    for name, row in rec["kernels"].items():
        old = parent.get(name, {})
        if not isinstance(row, dict) or "ms" not in row or "ms" not in old:
            continue
        row["parent_ms"] = old["ms"]
        log(f"[kernels] against the parent: {name} {row['ms']:.4f} ms, "
            f"parent {old['ms']:.4f} ms, ratio "
            f"{row['ms'] / old['ms']:.3f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(DEFAULT_PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (default: all but hybrid_layer, fp4_layer, "
                    "grouped_layer, w4a8_layer, hybrid_prefill_layer, "
                    "append_layer, fp4_wc_layer, decode_attn_layer and "
                    "hp_layer)")
    ap.add_argument("--record", help="write every measurement to this "
                    "JSON file")
    ap.add_argument("--parent-record", help="a --record file of another "
                    "tree's run (the parent commit's, in an A/B call): each "
                    "kernel row of this run also records that run's time "
                    "as parent_ms, and the log compares the two")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    rec = {}
    phase_device(rec)                    # always: no CUDA, no result
    with _AT_EXIT:
        for name in PHASES[1:]:
            if name in phases:
                t0 = time.perf_counter()
                globals()[f"phase_{name}"](rec)
                log(f"[{name}] phase done in "
                    f"{time.perf_counter() - t0:.1f} s")
    if args.parent_record and "kernels" in rec:
        _beside_parent(rec, args.parent_record)
    if args.record:
        os.makedirs(os.path.dirname(args.record) or ".", exist_ok=True)
        with open(args.record, "w") as f:
            json.dump(rec, f, indent=1)
    if all(p in rec for p in ("kernels", "solutions", "serve", "serve_kv",
                              "serve_block", "serve_moe", "serve_w4a8",
                              "serve_hybrid", "train", "load",
                              "serve_spec", "serve_parallel", "serve_pp",
                              "serve_cluster")):
        print(json.dumps({"kernels": [
            dict(name=name, route=info["route"], source=info["source"],
                 replaces=info["replaces"],
                 launches=rec["launches"][name],
                 **{key: rec["kernels"][name][key] for key in (
                     "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms")})
            for name, info in KERNELS.items()]}))
    print(rec["device"]["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
