#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with an NVIDIA H100, ``nvcc``
and PyTorch built for CUDA. In order, it:

1. builds every CUDA kernel of the serving and training paths from
   ``paddle_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel) and
   prints what ``-Xptxas -v`` reports;
2. holds each kernel against its plain PyTorch version on the card, at
   the shapes the serving path gives it (the int8 kernel exactly, the
   decode kernels on float32 and bfloat16 caches) and at the boundaries
   of the decode kernels' splits (the int8 kernel's k chunks, the dense
   and paged kernels' key chunks; the dense kernel bitwise equal to the
   paged one on the same logical rows, repeatable, its counters left at
   0; the paged kernel at the speculative verify's shape, each row
   bitwise equal to the same row alone), and small LMs on the card against the same LMs on the CPU
   (float32; int8 weights with bfloat16 caches, dense and paged);
3. makes full-width weights of the flagship LM (vocab 32768, d_model
   2048, 16 heads, d_ff 8192, 12 layers, 1024 positions) with numpy from
   the seed and loads them by their reference names through
   ``io.params_from_jax``;
4. serves four requests, prompts filling both prompt buckets (128, 512),
   32 new tokens each, through ``GenerationScheduler.submit`` on the dense
   KV layout, and checks the kernels' launch counts against admissions
   and decode steps;
5. serves five requests on the paged KV layout with the prefix cache on
   (block 16, a pool of 512 blocks): a 192-token system prompt with three
   suffixes, an exact repeat of the first request and one unrelated
   prompt; checks the prefix hits, the prefill windows, that every decode
   step went through the paged decode kernel, the pool's books, and the
   paged model's prefill logits (prefix hit and miss) against the dense
   model's;
6. serves the same five requests on a paged session with int8 weight
   compute and bfloat16 KV pools, and checks that every armed product
   went through the int8 kernel and every decode through the paged
   kernel, the prefix counters, the pool's bytes per block, and prints
   its tokens' agreement with the float32 session's;
7. runs the decode policies at that width, each session on the weights
   of one above by reference: the sampler on the card against the CPU
   (keys, random bits and uniforms bitwise, the Gumbel noise within 4
   ulp, tokens equal); the five requests sampled with fixed seeds
   (repeatable, seed-dependent, a replay of prompt + 16 tokens continuing
   the stream); speculative rounds (k 4) greedy and sampled with the
   1-layer self-draft, greedy on the int8/bf16 session, and with the
   whole target as the draft (which accepts, so later verify rows decide
   tokens) greedy on f32 and on int8/bf16 and sampled from the top two,
   against plain decoding (equal, or a
   first difference only at a near-tie), with the draft's launch counts
   and, armed, every product of target and draft through the int8
   kernel; a number-list grammar over the full vocabulary, greedy and
   sampled (every token legal), and a grammar that dies (its requests
   resolve with ConstraintDeadEnd);
8. drives the scheduler's resilience at that width (``[failover]``):
   a step failure mid-decode replays the five requests from their
   journals on a second session over the same weights, token for token
   equal to the fault-free run (greedy, sampled, int8/bf16, and a
   speculative pair against plain decoding); the failed session is
   rebuilt and serves again; a wedge past the step timeout is
   quarantined and rebuilt; a weight swap serves what a fresh session on
   the new weights serves; with the time per token with step timeouts
   off and on, the time to recover, to rebuild and to swap;
9. times prefill and decode steps end to end (dense, paged, and the
   int8/bf16 session beside them; sampled steps against greedy ones, the
   sampling alone, speculative rounds per emitted token at 8 active
   slots and at 1), profiles the three with
   torch.profiler (device-busy share, top kernels, the shares of the
   int8 and decode attention kernels; a sampled step against the
   sampling alone), and times each kernel on the
   device by both clocks (CUDA events over calls queued behind a sleep
   kernel, which the kernels line reports, and the profiler's kernel
   sums; the int8 kernel and its two other routes also summed per
   admission of each bucket and per decode step) beside its bound, its
   plain version and the one PyTorch call that computes the same
   function; the decode kernels (the int8 kernel at m <= 16 and its
   routes, both decode attention kernels) on a cold L2 too, over copies
   of their weights or caches, the warm time beside;
10. holds the fused 1x1 conv + BN-statistics kernel (B1) against its plain
   version at every shape of the ResNet-50 path and at ragged shapes
   (bitwise repeatable on scratch that held NaN, with a gradient check),
   and the probe T1 (a bf16 1x1 convolution on the tensor cores with a
   BN-apply + ReLU prologue) at its three cases and ragged ones; trains a
   small bottleneck ResNet on the card against the CPU, fused against
   unfused, and unfused under amp (bf16 convolutions) against the CPU;
11. frees the LM, then trains ResNet-50 as bench.py does on the
   accelerator (224 x 224, batch 256, Momentum(0.1, 0.9)) in float32 with
   fused_conv_bn on, through ``models.resnet.resnet_imagenet`` and
   ``trainer.train_step``: step time, images per second, f32 MFU, peak
   memory, 30 B1 launches per step; profiles one step and times B1 at
   each of its shapes by both clocks, and per step;
12. for the LM's training path: holds the flash kernel's bfloat16
   instantiation (B2 bf16) against its plain version at the training
   shape [8, 16, 1024, 128] and off it (head dim 64, segment ids, ragged
   T; bitwise repeatable), each tile of the block-size sweep (T2) with
   its time, and the autograd Function's backward against autograd of
   the plain reference; trains a 2-layer LM on the card against the CPU
   over 3 Adam steps, amp off and on;
13. runs ResNet-50 through the program path, as bench.py builds and
   runs it: the front end (``layers``, ``models.resnet.resnet_imagenet``
   given Variables), ``optimizer.Momentum(0.1, 0.9).minimize`` and
   ``core.Executor``, the startup program drawing the weights on the card
   from the seed: f32 with fused_conv_bn on (one step from the same
   weights against the nn.Module route, then timed steps beside
   ``[train]``'s, 30 B1 launches a step through the ``conv2d_bn`` op);
   under amp bfloat16 with fused_conv_bn off, bench.py's configuration
   (5 warm-up and 30 timed runs, images per second, bf16 MFU, peak
   memory, falling loss); and with each residual block recomputed (the
   first step's loss and running statistics equal to the plain
   program's, step time and peak memory beside it); and, after the small
   ResNets, ResNet-8 as a serialized program on the card against the
   CPU, amp off and on;
14. frees ResNet-50, then trains the flagship LM as bench.py does on the
   accelerator (batch 8, T 1024, amp bfloat16, Adam(1e-4), tokens and
   labels one draw) through ``TransformerLM``, ``optimizer.Adam`` and
   ``trainer.train_step``: the median step of 5 windows of 4, tokens per
   second, MFU at the bf16 peak, peak memory, falling losses, 12 bf16 B2
   launches per step; profiles one step and times B2 bf16 at the path's
   shape beside its bound, its plain version and SDPA.

15. serves through the generation programs
   (``GenerationSession(spec, scope)``): a small LM on the card against
   the CPU, greedy and sampled, dense, paged and speculative (after the
   small program phases, ``[small-program-serve]``); after the paged
   logits, the flagship LM's dense, f32 paged, int8/bf16 paged and
   speculative traffic on the module sessions' weights by reference,
   its tokens against the nn.Module route's, the launches of B2, B4, B5
   and B3 under program ops, TTFT, the decode step at 8 slots and one
   profiled step's device-busy share in turns with the nn.Module route,
   and the paged cell's peak beside the module cell's
   (``[program-serve]``); and ``bench.py``'s ``bench_generation``
   configuration, f32 and int8, 2 compiles each
   (``[program-generation]``).
16. trains ResNet-50 as bench.py's ``bench_resnet_pipeline`` does on the
   accelerator (224, batch 8, Momentum(0.1, 0.9), fused_conv_bn on)
   through ``Trainer.train`` and the staged input pipeline
   (``[pipeline]``): uint8 images and int32 labels packed into one block
   of the pinned staging arena per batch, one host-to-device copy a batch
   on the reader's own stream (counted by the staging counters and seen
   in a profiler trace as Pinned -> Device on a stream the step's kernels
   do not use), widened on the card; B1 30 times a step; one packed step
   equal to the bit to a step on the batch widened on the host, and a
   step resumed from a checkpoint equal to the bit to the uninterrupted
   one; compute, wire-copy and pipeline times, the overlap and images/s.

17. exports the flagship LM's forward program (is_test, T 512; at full
   width and, since the op tail's slice, half depth: 6 layers,
   ENGINE_LM) through ``io.save_inference_model``, f32 and int8, merges
   the f32 export into one file, and serves it through ``ServingEngine``
   (buckets 1 and 8, two replicas on the card, breakers, a per-call
   timeout) and ``MicroBatcher`` from 8 client threads (``[engine]``): a
   bucket-8 batch equal to a direct run, each request within 1e-3 of
   max|logits| of its row alone in bucket 1, B2 f32 one launch a layer
   an execution (B3 6 a layer and 1 on the int8 engine, whose scope
   keeps those weights int8), a replica failure failed over and
   re-admitted by the probe, a swap onto a seed-1 export equal to a
   direct run on it, a push under ``swap_canary_fail`` rejected, the
   merged-file engine equal to the directory engine, a
   2-layer artifact card against CPU, and ResNet-50's export refused as
   the reference refuses it (no running statistics in the artifact);
   batch times by bucket, requests/s and p50/p99, cold start, the swap's
   blackout, the time to re-admission and the weight bytes.
18. the compile cache and AOT (``[aot]``): the flagship LM's forward
   program stored to a ``compile_cache_dir`` by this process and loaded
   by a child process (one hit, no export, logits bitwise), a flipped
   byte of the stored blob quarantined and the step rebuilt, and
   ``[engine]``'s f32 and int8 artifacts exported with ``compiled/``
   buckets and served beside the same artifacts without them: cold
   start, the swap's blackout and the first batch after it (a
   recapture), batch times; no fallback, answers bitwise, launches
   exact. Since the same PR the executor's forward steps run as CUDA
   graphs from their second run: ``[program-serve]`` times the captured
   decode step of the dense, f32 paged and int8/bf16 cells beside the
   nn.Module route with each step's device-busy share, and
   ``[captures]`` fails the run if any capture failed.
19. the LeNet-5/MNIST slice, after the small program phases: every op
   type the slice ports (118) on the card against the CPU on the same
   inputs (``[ops]``, the cases of ``paddle_tpu_torch/probes/
   op_cases.py``): outputs on the card, a warm second call reading
   nothing back to the host, the 8 update rules in place over 3 steps,
   the random ops' draws bitwise, ``auc``'s counts accumulated over 3
   batches exact, the worst error of each op family against its
   tolerance; and LeNet-5 (BASELINE config 1: conv 20 and 50 filters
   5x5, pools 2x2, fc 10; batch 64, Adam(1e-3), the book test's
   synthetic digits from the seed) through ``Executor.run``
   (``[lenet]``): 5 steps on the card against the CPU from the same
   startup weights, 50 steps to a mean accuracy above 0.9 over the last
   10, the test program captured as a CUDA graph and its replay bitwise
   the eager run, the step time, images/s, one step's busy share and
   the peak memory.
20. the RNN and seq2seq slice, after ``[lenet]``: its 35 op types on the
   card against the CPU (``[ops]``: the cases of ``probes/op_cases.py``
   ``RNN_CASES`` and five control-flow and beam-search programs; no warm
   call reads back to the host but the unbounded ``while`` and ``cond``,
   whose reads are counted); a ``While(max_iters)`` RNN and a
   ``StaticRNN`` LSTM trained card against CPU, captured, replayed
   bitwise, and an unbounded ``While`` and a ``cond`` refused capture
   with their reasons (``[control-flow]``); ``bench.py``'s
   ``bench_seq2seq`` recipe (``[seq2seq]``: batch 128, length 50,
   vocabulary 30000, width 512, Adam(1e-3): 3 warm-up and 20 timed
   steps, ``seq2seq_train_tokens_per_sec``, then greedy and beam-4
   generation from the trained scope, eager and replayed, beam width 1
   equal to greedy; a small width card against CPU first);
   ``stacked_lstm_net`` at its defaults on the IMDB recipe's shapes
   (``[lstm-sentiment]``: batch 128, length 100, Adam(1e-3), step time,
   sequences/s, busy share, peak; the synthetic task learned on the
   card); and ``transformer_lm_generate`` at ``bench_paged_kv``'s
   configuration (``[lm-generate]``: beam 1, beam 4, sampling, eager
   and replayed, B2 f32 256 launches a call, beam 1 and sampling equal
   to a cached paged session's tokens).

21. the distribution slice, after ``[lenet]``: ``bench.py``'s
   ``bench_recsys`` recipe (``[recsys]``: wide&deep, BASELINE config 5:
   vocab 200,000, 26 slots, emb_dim 32, batch 4096, hidden (64, 32),
   Adagrad(0.05), distributed tables, packed feeds through
   ``StagedReader``: 3 steps card against CPU, the sparse gradients'
   shapes, 30 timed steps, ``recsys_examples_per_sec`` and
   ``embedding_lookup_rows_per_sec``, a profiled step's busy share, the
   a2a bytes a step; then an ``is_sparse`` pass); and the strategy route
   on a one-rank NCCL group (``[dist]``: the LM program at full width,
   2 layers, under ``transformer_tp_rules`` against no strategy, B2 bf16
   launched per shard; wide&deep under ``DataParallel(n_devices=1)``;
   ring attention over a one-rank axis against dense attention).
22. the fleet tier, after ``[aot]``: ``bench.py``'s ``bench_fleet`` and
   ``bench_model_paging`` recipes at the flagship LM's full width and
   depth, every member a ``python -m paddle_tpu_torch.probes.fleet_worker``
   process on this card (dense program sessions, 8 slots, cache 1024,
   buckets 128 and 512) loading one ``.npz`` of the reference child's
   ``build_scope`` weights, the router and the oracle (the same weights
   in a scheduler here) in this process (``[fleet]``): 12 prompts over
   two members, one SIGKILLed at streamed token 4, every stream equal to
   the oracle's (p99, ``paddle_fleet_recovery_seconds``, failovers, no
   journal reset); a scale-up through ``FleetAutoscaler.request_scale_up``
   with the compile cache warm (spawn to first token); a rolling deploy
   of a x1.01 push under two client threads (0 client errors, no mixed
   version, every response equal to its version's oracle); and
   (``[model-paging]``) models A (seed 7) and B (seed 11, drawn in a
   child process beside ``[fleet]``) under a 1.5-model resident budget
   over two members resident for A: the first B request pages B in and
   evicts A (``model_page_in_ms``), 24 mixed requests then hit resident
   members (the hit rate), 0 client errors, every stream its model's
   oracle's. Each member that stops prints its launches: B2 12 an
   admission and B4 12 a decode step, both launched, nothing else.
23. the op tail, after the RNN slice's ``[ops]`` and after ``[lenet]``:
   its 17 op types on the card against the CPU (``[ops]``, the cases of
   ``probes/op_cases.py`` ``TAIL_CASES``: no warm call reads back to the
   host but ``print``'s, whose line is checked; all 219 op types
   registered, none pending); ``models/ssd.py`` at 300², VOC's 21
   classes, batch 32 (``[detection]``: a step card against CPU, 30 steps
   halving the loss, the detections card against CPU with no host read,
   ``DetectionMAP`` equal, the step, images/s, busy share, peak); and the
   ``benchmark/paddle/image`` recipes (``[vision]``: AlexNet, VGG-19 and
   GoogLeNet at 224² and SmallNet at 32², batch 64, Momentum(0.01, 0.9):
   a step card against CPU, 10 timed steps beside their reckoned bound,
   SmallNet's ``Accuracy`` evaluator against its steps' accuracy).
24. the v2 API, after ``[lstm-sentiment]`` (``[v2]``): the IMDB recipe of
   ``benchmark/paddle/rnn`` written in v2 layers at ``[lstm-sentiment]``'s
   widths (vocabulary 30000, embedding 128, hidden 512, 3 fc + lstmemory
   pairs, batch 128, padded length 100) trained by
   ``paddle.trainer.SGD.train`` over ``paddle.batch`` of Python samples
   with ``feeding``: the step from ``EndIteration`` events (10 warm-up
   steps, 5 windows of 10), a step's busy share, the peak, beside
   ``[lstm-sentiment]``'s step; ``SGD.test`` and ``paddle.infer`` on the
   card; the card's ``Parameters.to_tar`` into a CPU build of the same
   topology, whose ``paddle.infer`` the card's must match; at a small
   width 5 steps card against CPU from one tar; and the book's
   ``recognize_digits`` conv net over ``paddle.dataset.mnist.train()``
   (30 steps whose loss falls, 3 steps card against CPU).

Any failed phase exits nonzero. The line before the last is the card's
name and power limit from nvidia-smi; the one before that lists the
kernels as JSON; the last line is ``{"ok": true, "device": ...}``.
"""

import argparse
import collections
import contextlib
import functools
import gc
import json
import subprocess
import sys
import time

import numpy as np

# the H100's data-sheet peaks, the training program's reckoned work and
# the card's nvidia-smi line, shared with the measurement probes
from paddle_tpu_torch.probes.common import (BF16_FLOPS, F32_FLOPS,
                                            HBM_BYTES_PER_S, INT8_OPS,
                                            card_line, program_work)

FULL = dict(vocab_size=32768, d_model=2048, num_heads=16, d_ff=8192,
            num_layers=12, max_len=1024)
SLOTS, CACHE_LEN, BUCKETS = 8, 1024, (128, 512)
PROMPT_LENS = (100, 128, 300, 512)
NEW_TOKENS = 32
# kernel vs plain version on the card: both f32, sums in another order
KERNEL_ATOL = 1e-4
# the small LM on the card vs on the CPU: f32 through two layers
LM_ATOL = 1e-4
# the paged cell: block 16, the pool auto-sized to byte parity with the
# dense cache (8 slots x 64 blocks), prefix cache on; the traffic is a
# 192-token (12-block) system prompt with three suffixes, a repeat of the
# first request and one unrelated prompt
BLOCK_SIZE = 16
SYSTEM_LEN, SUFFIX_LENS, UNRELATED_LEN = 192, (36, 108, 308), 100
# paged vs dense prefill logits at full width: f32 through 12 layers,
# prefill attention by two codes (the flash kernel, plain torch over the
# gathered pool), sums in another order
PAGED_LOGITS_ATOL = 1e-3
# int8 compute: the int8 products per admission and per decode step
# (q, k, v, o, ffn1, ffn2 in each layer, and the LM head), and the
# (m, k, n) of each product on the path: decode m = 8, prefill windows
# padded to a bucket (128, 512), the LM head at prefill m = 1
INT8_PER_PASS = 6 * FULL["num_layers"] + 1
INT8_KN = ((FULL["d_model"], FULL["d_model"]),
           (FULL["d_model"], FULL["d_ff"]), (FULL["d_ff"], FULL["d_model"]))
INT8_SHAPES = tuple((m, k, n) for m in (SLOTS,) + BUCKETS
                    for k, n in INT8_KN) \
    + ((SLOTS, FULL["d_model"], FULL["vocab_size"]),
       (1, FULL["d_model"], FULL["vocab_size"]))
# ragged shapes off the path, and every path shape, for the exact compare:
# (17, 100, 33) takes the 32 x 64 prefill tile
INT8_RAGGED = ((3, 200, 72), (5, 37, 19), (17, 100, 33))
# ragged shapes on the 64 x 128 prefill tile (a ragged m, k and n: the
# weight's byte-wise loads), drawn from a stream of their own
INT8_RAGGED_WIDE = ((1000, 130, 2001),)
# the decode path's split-K boundaries, from that stream too: m 1, 8 and
# 16 (16 takes the kernel's 16-row instantiation), k not a multiple of
# the split chunk (1000 and 8200 over 256-row sub-stages, 4100 over the
# plan's chunks), a ragged n; each x but the m = 1 one has a zero row
INT8_SPLIT_EDGES = ((1, 2048, 2048), (16, 2048, 2048), (3, 1000, 2001),
                    (16, 8200, 130), (8, 4100, 2048), (2, 2048, 2048))
# the small LM with int8 weights and bf16 caches, card vs CPU: their f32
# parts differ in the last bits, which can move one element's int8
# rounding by one step. One step of the LM head's input moves a logit
# by at most amax(head input) * max(head scale) (q * x_scale * w_scale
# with |q| <= 127 and x_scale = amax / 127); flips in earlier layers
# reach the logits through the residual and the final layer norm. The
# logits are held to LM_INT8_STEPS such steps, computed from the CPU
# model in the run.
LM_INT8_STEPS = 4
# host-clock latencies spread by tens of percent between rounds (the
# step is host-bound): medians of this many rounds, every round printed
LATENCY_ROUNDS = 7
# decode policies on the paged cell's traffic: sampling at temperature
# 0.8, top-k 50, top-p 0.95 with fixed request seeds; a replay re-admits
# prompt + the first REPLAY_CUT tokens; speculative rounds of SPEC_K
# drafts from the default 1-layer self-draft. A speculative stream equals
# the plain one or first differs where the target's top two scores lie
# within NEAR_TIE (the 12-layer logit tolerance: verify and decode are
# two codes)
SAMPLE_KNOBS = dict(temperature=0.8, top_k=50, top_p=0.95)
# the sampled cell whose draft is the whole target: the draft is greedy,
# so a draft is accepted when the target's draw is its argmax; on random
# weights the top 50 scores lie close and SAMPLE_KNOBS' draw is rarely
# the argmax. A draw between the top two at temperature 1 takes it about
# half the time, so verify rows past the first decide sampled tokens,
# and the key of each row still decides the draw
SPEC_SAMPLE_KNOBS = dict(temperature=1.0, top_k=2)
SAMPLE_SEEDS = (11, 12, 13, 14, 15)
REPLAY_CUT = 16
SPEC_K = 4
NEAR_TIE = PAGED_LOGITS_ATOL
# [compare] B5 at the verify forward's shape: histories whose window of
# SPEC_K + 1 lengths crosses a block boundary, stays inside one block,
# and ends at the table's whole width; the phase adds one whose window
# crosses the split's chunk boundary
VERIFY_HISTS = (2 * BLOCK_SIZE - 2, 5 * BLOCK_SIZE + 4,
                CACHE_LEN - (SPEC_K + 1))
# [compare] sample: the sampler card vs CPU at [8, vocab] logits over 64
# (seed, step) pairs under four settings (the last with mask rows); the
# Gumbel noise within 4 ulp at max(|g|, 1) (its error is absolute near
# g = 0, where the outer log's argument is near 1), though computed in
# float64 and rounded once it is expected bitwise equal
SAMPLE_PAIRS = 64
# the [failover] phase: the scheduler's recovery flags (replay, breakers
# of one failure with a minute's cooldown, one rebuild a session); the
# fault lands on session 0's FAIL_AT_STEP-th decode step; a wedge sleeps
# WEDGE_SLEEP_S past a WEDGE_TIMEOUT_MS step timeout (a full-width step
# at 8 slots takes ~5 ms); the time per token with timeouts off and on
# over TIMING_ROUNDS rounds in turns
FAILOVER_FLAGS = dict(replay_attempts=4, breaker_failures=1,
                      breaker_cooldown_ms=60000.0, rebuild_limit=1)
FAIL_AT_STEP = 8
WEDGE_TIMEOUT_MS = 1000.0
WEDGE_SLEEP_S = 4.0
TIMING_ROUNDS = 3
GUMBEL_ULPS = 4
SAMPLE_GRID = (("t1", dict(), False),
               ("t0.8 k50", dict(temperature=0.8, top_k=50), False),
               ("t0.8 p0.95", dict(temperature=0.8, top_p=0.95), False),
               ("k50 p0.9 mask", dict(top_k=50, top_p=0.9), True))
# ResNet-50 training as bench.py trains it on the accelerator
# (resnet_imagenet depth 50, 224 x 224, 1000 classes, batch 256,
# Momentum(0.1, 0.9), random images and labels from a seed), in float32
# with fused_conv_bn on: the path that runs kernel B1, 30 launches per
# step. bench.py counts a training step as 3 x the forward's 4.1 G
# multiply-adds per image at 224, and labels the 12.3 G "GFLOP"; a FLOP
# here is one multiply or one add, as in every bound of this script, so
# a step does 2 x 12.3 = 24.6 GFLOP per image. MFU is reported in both
TRAIN = dict(depth=50, res=224, batch=256, class_dim=1000, lr=0.1,
             momentum=0.9)
TRAIN_WARMUP, TRAIN_STEPS = 3, 8
TRAIN_GMAC_PER_IMAGE = 12.3
TRAIN_GFLOP_PER_IMAGE = 2 * TRAIN_GMAC_PER_IMAGE
B1_PER_STEP = 30
# B1's (C, O, H = W) on the path, at batch 256
B1_SHAPES = ((64, 64, 56), (64, 256, 56), (256, 64, 56), (512, 128, 28),
             (128, 512, 28), (1024, 256, 14), (256, 1024, 14),
             (2048, 512, 7), (512, 2048, 7))
# ragged shapes off the path: (N, C, O, H, W); pixel tiles that span
# images with P % 4 != 0 (4-byte copies) and with P % 4 == 0 (16-byte
# copies), C not a multiple of the kernel's 16-deep stages, two channel
# tiles with a ragged second
B1_RAGGED = ((3, 37, 19, 5, 7), (2, 5, 130, 1, 1), (7, 96, 40, 9, 11),
             (5, 72, 136, 6, 6), (9, 130, 200, 7, 7))
# B1 vs its plain version (cuDNN's f32 convolution, TF32 off, and torch's
# sums), both f32 with sums in other orders: y within B1_RTOL of max|y|,
# each channel's sum within B1_RTOL of the sum of |y| it adds (a sum of
# signed terms cancels), sum of squares and the variance E[y^2] - E[y]^2
# within B1_RTOL of E[y^2] (the formula cancels in f32; the reference
# uses it too)
B1_RTOL = 1e-5
# the probe T1's three ResNet cases (tools/fused_conv_bn_probe.py): rows
# R = 256 H W, C -> O, bf16; held to one bf16 step of max|y| and its f32
# sums to T1_SUM_RTOL of the sum of |y| (or y^2) they add
T1_CASES = (("stage2 28x28 128->512", 256 * 28 * 28, 128, 512),
            ("stage3 14x14 256->1024", 256 * 14 * 14, 256, 1024),
            ("stage1 56x56 64->256", 256 * 56 * 56, 64, 256))
T1_SUM_RTOL = 1e-5
# T1 off the probe's cases (R, C, O), from a torch stream of their own:
# ragged R, C and O (element-wise copies and stores), more channels than
# a z tile holds (256-channel chunks), a single row
T1_RAGGED = ((1000, 72, 136), (333, 37, 21), (700, 600, 264), (1, 8, 8))
# the small bottleneck ResNet, card vs CPU over 3 Momentum steps (f32,
# B1 and cuDNN on the card, the plain versions on the CPU): losses,
# parameters, velocities and running statistics within SMALL_RESNET_RTOL
# of each tensor's norm; fused vs unfused on the card: losses at the
# reference's own rtol (tests/test_quant_compute.py)
SMALL_RESNET_RTOL = 1e-4
FUSED_UNFUSED_RTOL = 1e-4
# the same ResNet unfused under amp bf16, card vs CPU: bf16 convolutions
# (cuDNN on the card, oneDNN on the CPU) summed in other orders, the LM's
# amp tolerances: losses to 1e-2 relative, parameters within 2 lr a step
SMALL_RESNET_AMP_RTOL = 1e-2
# its 1x1 stride-1 convolutions: the first block's shortcut, conv1 and
# conv3, the second block's conv3
SMALL_B1_PER_STEP = 4
# ResNet-50 through the program path (front end, Momentum.minimize,
# Executor.run) as bench.py's bench_resnet runs it on the accelerator:
# TRAIN's configuration, amp bfloat16 (bench.py:2088), fused_conv_bn off,
# the startup program's weights from seed 0, bench.py's feed
# (RandomState(0) images, int labels in [0, 1000)) on the card once; 5
# warm-up and 30 timed Executor.run calls closed by one synchronize; the
# MFU at the bf16 peak, a FLOP one multiply or one add (24.6 GFLOP an
# image)
PROGRAM_WARMUP, PROGRAM_STEPS = 5, 30
# the same program f32 with fused_conv_bn on (B1, 30 launches a step
# through the executor's conv2d_bn op): 3 warm-up and 8 timed steps, each
# ended by a synchronize as [train]'s; and with each residual block
# recomputed: 2 warm-up and 10 timed steps
PROGRAM_FUSED_WARMUP, PROGRAM_FUSED_STEPS = 3, 8
PROGRAM_RECOMPUTE_WARMUP, PROGRAM_RECOMPUTE_STEPS = 2, 10
# one step from the same weights: the executor against the nn.Module
# route (f32, fused), and recompute against no recompute (bf16): losses
# and running statistics within this relative distance
PROGRAM_ROUTE_RTOL = 1e-5
# bench.py's bench_resnet_pipeline on the accelerator: ResNet-50 at 224,
# batch 8, Momentum(0.1, 0.9), uint8 images widened by 1/255 on the card,
# 16 timed steps; the wire copy timed 4 times before and 4 after the pass;
# a checkpoint every 4 steps for the resume check
PIPELINE = dict(depth=50, res=224, batch=8, class_dim=1000, lr=0.1,
                momentum=0.9, steps=16, h2d_reps=4, ckpt_every=4)
PIPELINE_SCALE = 1.0 / 255.0
# how long [pipeline]'s profiled window runs small ops before the staged
# pass, seconds
PIPELINE_PROFILE_SETTLE_S = 0.05
# [resilient]: ResilientTrainer over [pipeline]'s configuration: passes of
# ``steps`` batches; a NaN loss at step ``skip_at`` (0-based) skipped, one
# at ``rollback_at`` rolled back to the checkpoint of every ``ckpt_every``
# steps with the learning rate times ``lr_backoff``; a reader error before
# batch ``reader_fault_at``; SIGTERM after step ``preempt_at``; a step held
# ``hang_s`` past a ``deadline_s`` watchdog; ``timing_steps`` a timed pass
RESILIENT = dict(steps=6, skip_at=2, rollback_at=5, rollback_steps=8,
                 ckpt_every=4, lr_backoff=0.5, reader_fault_at=3,
                 preempt_at=3, deadline_s=1.0, hang_s=1.5, timing_steps=8)
# [elastic]: the master's heartbeat deadline (bench.py's 400 ms), the
# workers' beat, the rendezvous settle (past the deadline), the RecordIO
# samples (8 a chunk and a batch), checkpoints every ``ckpt_every``
# steps, a silent peer joining after step ``join_at``, a step hung at
# ``hang_at`` under a ``deadline_s`` watchdog
ELASTIC = dict(hb_timeout_ms=400, hb_interval_s=0.1, settle_s=0.6,
               samples=48, ckpt_every=2, join_at=2, hang_at=3,
               deadline_s=2.0, init_timeout_s=60)
# bench.py's bench_slo detection latency, deterministic on its driven
# clock: the reference's value (tests/test_torch_telemetry.py computes it)
SLO_DETECTION_MS = 250.0
# ResNet-8 for CIFAR as a serialized program, card vs CPU over 2
# Momentum steps (batch 32, 16 x 16): f32 within SMALL_RESNET_RTOL of each
# tensor's norm; under amp the small-ResNet amp tolerances (losses
# SMALL_RESNET_AMP_RTOL, parameters within 2 lr a step). At batch 8 the
# second step's gradients of this net are ill-conditioned in f32 (on the
# CPU alone, f32 against float64 moves some velocities by more than the
# tolerance): batch 32 holds f32 to its rounding
SMALL_PROGRAM = dict(depth=8, res=16, batch=32, lr=0.1, steps=2)
# the transformer LM's training step as bench.py runs it on the
# accelerator (bench_transformer_lm: FULL's widths at T 1024, batch 8,
# amp bfloat16, Adam(1e-4), tokens and labels one randint(2, vocab)
# draw): 2 warm-up steps, then 5 windows of 4 steps each closed by a
# synchronize, the median window; FLOPs a token 6N + 6 L T d
LM_TRAIN = dict(batch=8, seqlen=1024, lr=1e-4)
LM_WARMUP, LM_WINDOWS, LM_WINDOW_STEPS = 2, 5, 4
# B2 bf16 against its plain version: the kernel rounds the unnormalized
# probabilities to bf16 for its PV product on the tensor cores (the
# reference kernel's bf16 pass on its own chip), the plain version keeps
# them f32; each p carries at most half a bf16 step (2^-9) of relative
# error, so the output moves by less than one bf16 step (2^-7) of its
# magnitude, which also covers the final rounding and sums in another
# order
BF16_STEP = 2.0 ** -7
# the training attention shape [B, H, T, D]
LM_ATTN = (LM_TRAIN["batch"], FULL["num_heads"], LM_TRAIN["seqlen"],
           FULL["d_model"] // FULL["num_heads"])
# the Function's backward (the reference's chunked recompute) against
# autograd of the plain reference over f32-upcast inputs: f32 sums in
# another order (1e-4 of each gradient's magnitude); bf16 gradients are
# that f32 value rounded once (one bf16 step)
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": BF16_STEP}
# the small LM (head dim 128) over 3 Adam(1e-3) steps, card vs CPU from
# the same weights: losses within rtol 1e-4 (f32) / 1e-2 (amp: bf16
# products summed in other orders); every parameter within 2 lr a step of
# the CPU's (Adam moves an element by about lr a step, by lr * sign(g)
# in its first, so an element whose gradient is near 0 may go either
# way); SMALL_LM_NEAR[amp] = (near, share): at least that share of each
# tensor's elements within near lr
SMALL_LM_CFG = dict(vocab_size=512, d_model=256, num_heads=2, d_ff=512,
                    num_layers=2)
SMALL_LM_T, SMALL_LM_BATCH, SMALL_LM_LR, SMALL_LM_STEPS = 256, 4, 1e-3, 3
SMALL_LM_LOSS_RTOL = {None: 1e-4, "bfloat16": 1e-2}
SMALL_LM_NEAR = {None: (1e-3, 0.99), "bfloat16": (0.1, 0.90)}
# the LM's program route (the front end's transformer_lm given
# Variables, Adam(1e-4).minimize, Executor.run) as bench.py's
# bench_transformer_lm runs it: LM_TRAIN's configuration and windows, the
# weights from the startup program on the card (seed 0), bench.py's feed
# (RandomState(0).randint(2, vocab) for tokens and labels) on the card
# once; B2 bf16 12 a step and no other kernel; one step from the
# startup weights against the nn.Module route: the loss within
# PROGRAM_LM_LOSS_RTOL relative, every parameter within 2 lr (PERF.md
# §2's small-LM bound at full width) once the rounding of the two updated
# values is taken off, and Adam's moments, which hold the gradients, each
# leaf within PROGRAM_LM_GRAD_RTOL of its largest magnitude (the second
# moment, a square, twice that); the peak memory within
# PROGRAM_LM_PEAK of [lm-train]'s
PROGRAM_LM_LOSS_RTOL = 1e-4
PROGRAM_LM_GRAD_RTOL = 1e-4
PROGRAM_LM_PEAK = 0.10
# the LM's forward program (is_test) at batch 1 x T 512 armed by
# arm_quant_compute([program], scope): 6 products a layer and the head
# through B3 a run; the logits against the nn.Module int8 route on the
# same int8 weights within LM_INT8_STEPS head quantization steps;
# PROGRAM_INT8_RUNS timed runs each, armed and f32, the median
PROGRAM_INT8_T, PROGRAM_INT8_RUNS = 512, 5
# the program's (m, k, n) that the serving path does not run: the LM head
# at m = T, held bitwise against the plain version and timed, from a
# stream of its own
PROGRAM_INT8_SHAPES = ((PROGRAM_INT8_T, FULL["d_model"], FULL["vocab_size"]),)
# the LM program at a small width (one head: B2 takes head dims 64 and
# 128), serialized and loaded, card vs CPU over SMALL_LM_STEPS Adam
# steps at SMALL_LM_LR, amp off and on, to SMALL_LM_LOSS_RTOL and 2 lr a
# step; with dropout 0.1 the masks torch.equal card to CPU
SMALL_PROGRAM_LM = dict(vocab_size=512, d_model=64, num_heads=1, d_ff=128,
                        num_layers=2)
SMALL_PROGRAM_LM_T, SMALL_PROGRAM_LM_BATCH = 64, 4
# [small-program-serve]: the CPU tests' small LM
# (tests/test_torch_program_generation.py) served through the generation
# programs on the card and on the CPU, standard-normal weights from the
# seed: greedy dense, greedy paged with the prefix cache, sampled dense
# and speculative paged (the whole target as the draft), tokens equal
# card to CPU. Its width is 128, not the tests' 32: two heads of 64, the
# least head dimension kernels B2, B4 and B5 are built for
SMALL_SERVE = dict(vocab_size=64, d_model=128, num_heads=2, d_ff=64,
                   num_layers=2, max_len=32)
SMALL_SERVE_KW = dict(slots=4, prompt_buckets=(8, 16), eos_id=1,
                      block_size=4)
SMALL_SERVE_PROMPTS = ([0, 5, 7], [2, 3, 4, 5, 6, 7, 8, 9, 10],
                       [2, 3, 4, 5, 6, 7, 8, 9, 11], [9, 3, 2, 11, 4])
SMALL_SERVE_NEW = 10
# [program-serve]: the program-served paged cell's peak (its weights, its
# pools and the peak allocation above them while it serves) within this
# share of the module-served cell's
PROGRAM_PEAK_RTOL = 0.02
# [program-generation]: bench.py's bench_generation on the accelerator
# (vocab 1024, d_model 512, 8 heads, d_ff 2048, 4 layers, 8 slots, prompt
# bucket 8, 64 steps, max_len 128), weights from the transformer_lm
# program's startup
PROGRAM_GENERATION = dict(vocab_size=1024, d_model=512, num_heads=8,
                          d_ff=2048, num_layers=4)
PROGRAM_GENERATION_SLOTS, PROGRAM_GENERATION_STEPS = 8, 64


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def two_clocks(fn, iters=10):
    """(ms between CUDA events of queued calls, profiler device ms) per
    call of ``fn()``, its launches uncounted."""
    from paddle_tpu_torch.probes.common import cuda_ms, device_ms
    return uncounted(lambda: (cuda_ms(fn, iters=iters),
                              device_ms(fn, iters=iters)))


def cold_ms(make, nbytes, iters=30):
    """ms per call between CUDA events of queued calls, each over buffers
    the L2 has not held since COLD_BYTES ago (``probes.common``
    ``cold_calls``: ``make()`` gives a call over copies of its own, of
    which it reads ``nbytes``), launches uncounted: how the decode path
    finds its weights and caches."""
    from paddle_tpu_torch.probes.common import cold_calls, cuda_ms
    return uncounted(lambda: cuda_ms(cold_calls(make, nbytes), iters=iters))


def roofline_ms(nbytes, flops, peak=F32_FLOPS):
    """The least time the card could take for work that moves ``nbytes``
    and does ``flops`` operations at ``peak`` per second (default f32):
    (ms, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes > t_ops else "operations"


@contextlib.contextmanager
def amp_flag(value):
    """The ``amp`` flag set to ``value`` inside the block and off after:
    the port's models read it at each call, as the reference's executor
    does at each run."""
    from paddle_tpu_torch import config
    config.set_flags(amp=value)
    try:
        yield
    finally:
        config.set_flags(amp=None)


def counters():
    """{kernel name: (its wrapper, the attribute counting its launches)};
    B2's wrapper counts every launch and, apart, its bfloat16 ones."""
    from paddle_tpu_torch.ops import conv_bn
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import quant_ops
    return {"flash_attention": (fa.flash_attention, "launches"),
            "flash_attention bf16": (fa.flash_attention, "launches_bf16"),
            "flash_attention_tile": (fa.flash_attention_tile, "launches"),
            "decode_attention": (fa.decode_attention, "launches"),
            "decode_attention_paged": (fa.decode_attention_paged,
                                       "launches"),
            "int8_matmul": (quant_ops.quant_matmul_2d, "launches"),
            "conv_bn_stats": (conv_bn.conv_bn_stats_1x1, "launches"),
            "conv1x1_bn_relu": (conv_bn.conv1x1_bn_relu, "launches")}


def reset_launches():
    from paddle_tpu_torch.ops import quant_ops
    for fn, attr in counters().values():
        setattr(fn, attr, 0)
    quant_ops.quant_matmul_2d.launches_by_shape.clear()


def read_launches():
    return {name: getattr(fn, attr)
            for name, (fn, attr) in counters().items()}


def read_int8_shapes():
    """B3's launches by (m, k, n), counted by its wrapper at the launch."""
    from paddle_tpu_torch.ops import quant_ops
    return dict(quant_ops.quant_matmul_2d.launches_by_shape)


def uncounted(fn):
    """Call ``fn()`` and leave every launch count as it was: the launches
    of comparisons and timings are not the main path's."""
    from paddle_tpu_torch.ops import quant_ops
    saved = read_launches()
    by_shape = quant_ops.quant_matmul_2d.launches_by_shape
    saved_shapes = dict(by_shape)
    try:
        return fn()
    finally:
        for name, (w, attr) in counters().items():
            setattr(w, attr, saved[name])
        by_shape.clear()
        by_shape.update(saved_shapes)


def counted(fn):
    """Call ``fn()`` with every launch count at 0 just before it: returns
    (its result, the launches it made by kernel, read just after). The
    counts then go on from where they were with the call's launches
    added, since the call is part of the path they count."""
    from paddle_tpu_torch.ops import quant_ops
    saved = read_launches()
    by_shape = quant_ops.quant_matmul_2d.launches_by_shape
    saved_shapes = dict(by_shape)
    reset_launches()
    try:
        out = fn()
    finally:
        got = read_launches()
        shapes = dict(by_shape)
        for name, (w, attr) in counters().items():
            setattr(w, attr, saved[name] + got[name])
        by_shape.clear()
        by_shape.update(saved_shapes)
        for key, n in shapes.items():
            by_shape[key] = by_shape.get(key, 0) + n
    return out, got


def make_params(cfg, rng):
    """Reference-named LM weights: matrices normal(0, 0.02), biases 0,
    layer-norm scales 1 and shifts 0 (the reference's initializers)."""
    from paddle_tpu_torch.models.transformer import lm_param_names
    v, d, f = cfg["vocab_size"], cfg["d_model"], cfg["d_ff"]
    shapes = {"tok_embedding": (v, d), "pos_encoding_0.w_0":
              (cfg["max_len"], d), "lm_head.w": (d, v)}
    named = {}
    for name in lm_param_names(cfg["num_layers"]):
        if name.startswith("layer_norm_"):
            fill = 1.0 if name.endswith(".w_0") else 0.0
            named[name] = np.full(d, fill, np.float32)
        elif name.endswith(".b"):
            named[name] = np.zeros(f if ".ffn1." in name else d, np.float32)
        else:
            shape = shapes.get(name)
            if shape is None:
                shape = ((d, f) if ".ffn1." in name else
                         (f, d) if ".ffn2." in name else (d, d))
            w = rng.standard_normal(shape, dtype=np.float32)
            w *= 0.02
            named[name] = w
    return named


def phase_build():
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build(force=True)
    print("[build] %d kernel sources in %.1f s"
          % (len(logs), time.perf_counter() - t0))
    for stem, log in sorted(logs.items()):
        for line in log.splitlines():
            if "ptxas" in line or "spill" in line:
                print("[build] %s: %s" % (stem, line.strip()))


def phase_compare(rng):
    """Each kernel against its plain version on the same card inputs."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    h, d = FULL["num_heads"], FULL["d_model"] // FULL["num_heads"]
    flash_errs = []
    for p, n in ((128, 100), (512, 300), (512, 512)):
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (1, h, p, d), dtype=np.float32)).cuda() for _ in range(3))
        seg = (torch.arange(p, device="cuda")[None] < n).to(torch.int32)
        got = fa.flash_attention(q, k, v, causal=True, segment_ids=seg)
        want = fa.flash_attention_plain(q, k, v, True, seg)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        flash_errs.append(err)
        print("[compare] flash_attention P=%d len=%d max_abs_err=%.3g "
              "(tol %g)" % (p, n, err, KERNEL_ATOL))
        check(err <= KERNEL_ATOL, "flash_attention disagrees: %g" % err)
        check(not got[:, :, n:].any(), "flash_attention padded rows not 0")
    # transformer_lm_generate's step sub-block: causal, no segment ids,
    # 8 heads of 64 over the 64-token window, batch 8 (beam 1, sampling)
    # and 32 (beam 4); drawn from a generator of its own so that the
    # cases below keep their inputs
    gen_rng = np.random.default_rng(LM_GENERATE["max_len"])
    for n in (LM_GENERATE_BATCH, 4 * LM_GENERATE_BATCH):
        shape = (n, LM_GENERATE["num_heads"], LM_GENERATE["max_len"],
                 LM_GENERATE["d_model"] // LM_GENERATE["num_heads"])
        q, k, v = (torch.from_numpy(gen_rng.standard_normal(
            shape, dtype=np.float32)).cuda() for _ in range(3))
        err = float((fa.flash_attention(q, k, v, True) -
                     fa.flash_attention_plain(q, k, v, True)).abs().max())
        flash_errs.append(err)
        print("[compare] flash_attention causal=True %s seg=None (the "
              "[lm-generate] step) max_abs_err=%.3g (tol %g)"
              % (list(shape), err, KERNEL_ATOL))
        check(err <= KERNEL_ATOL, "flash_attention disagrees: %g" % err)
    # off the main path: no segment ids, non-causal, head dim 64, ragged T
    for causal, p, n, hd in ((True, 100, None, 128), (False, 200, 77, 64)):
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (2, 4, p, hd), dtype=np.float32)).cuda() for _ in range(3))
        seg = None if n is None else \
            (torch.arange(p, device="cuda")[None] < n).to(torch.int32) \
            .expand(2, p).contiguous()
        err = float((fa.flash_attention(q, k, v, causal, seg) -
                     fa.flash_attention_plain(q, k, v, causal, seg))
                    .abs().max())
        print("[compare] flash_attention causal=%s T=%d seg=%s D=%d "
              "max_abs_err=%.3g (tol %g)" % (causal, p, n, hd, err,
                                             KERNEL_ATOL))
        check(err <= KERNEL_ATOL, "flash_attention disagrees: %g" % err)
    decode_errs = []
    for s, c, hh, hd, lens in (
            (SLOTS, CACHE_LEN, h, d, [1, 7, 129, 300, 512, 513, 1000, 1024]),
            (3, 100, 4, 64, [1, 50, 100])):
        q = torch.from_numpy(rng.standard_normal((s, hh * hd),
                                                 dtype=np.float32))
        kc, vc = (torch.from_numpy(rng.standard_normal(
            (s, c, hh * hd), dtype=np.float32)) for _ in range(2))
        q, kc, vc = q.cuda(), kc.cuda(), vc.cuda()
        lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got = fa.decode_attention(q, kc, vc, lens, hh)
        want = fa.decode_attention_plain(q, kc, vc, lens, hh)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print("[compare] decode_attention S=%d C=%d H=%d D=%d "
              "max_abs_err=%.3g (tol %g)" % (s, c, hh, hd, err, KERNEL_ATOL))
        check(err <= KERNEL_ATOL, "decode_attention disagrees: %g" % err)
        if hh == h:
            decode_errs.append(err)
    return {"flash_attention": max(flash_errs),
            "decode_attention": max(decode_errs)}


def paged_case(rng, lens, heads, d, nb, bs, mb, poison=True, dtype=None):
    """Decode inputs on the card over a paged cache: q [S, H*D], pools
    [NB, BS, H*D] (of ``dtype``, default float32) whose blocks no table
    references are NaN (when ``poison``), scattered unordered tables
    [S, MB] (a slot of length 0 in ``lens`` gets an all-dead row,
    entries = NB, and runs at length 1, as the session runs inactive
    slots) and int32 lengths."""
    import torch
    s, hd = len(lens), heads * d
    tables = np.full((s, mb), nb, np.int32)
    perm = iter(rng.permutation(nb))
    for si, n in enumerate(lens):
        for j in range(-(-n // bs)):
            tables[si, j] = next(perm)
    used = np.unique(tables[tables < nb])
    fill = float("nan") if poison else 0.0
    pools = []
    for _ in range(2):
        pool = torch.full((nb, bs, hd), fill, device="cuda")
        pool[torch.from_numpy(used).cuda()] = torch.from_numpy(
            rng.standard_normal((used.size, bs, hd), dtype=np.float32)).cuda()
        pools.append(pool if dtype is None else pool.to(dtype))
    q = torch.from_numpy(rng.standard_normal((s, hd),
                                             dtype=np.float32)).cuda()
    lengths = torch.tensor([max(n, 1) for n in lens], dtype=torch.int32,
                           device="cuda")
    return q, pools[0], pools[1], lengths, torch.from_numpy(tables).cuda()


def phase_compare_paged(rng):
    """The paged decode kernel against its plain version, and bitwise
    against the dense decode kernel on the same logical cache (the two
    share the split-key body), at the path's shape (S 8, H 16, D 128, BS
    16, MB 64, NB 512) and at D 64, BS 8. The last slot's table row is
    all dead: its output is left out of the comparison, but its launch
    must not fault."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    h, d = FULL["num_heads"], FULL["d_model"] // FULL["num_heads"]
    mb = -(-CACHE_LEN // BLOCK_SIZE)
    worst = 0.0
    for lens, hh, hd, nb, bs, cmb in (
            ([1, 16, 17, 100, 300, 513, 1024, 0], h, d, SLOTS * mb,
             BLOCK_SIZE, mb),
            ([1, 9, 80, 0], 4, 64, 40, 8, 10)):
        q, pk, pv, lengths, tables = paged_case(rng, lens, hh, hd, nb, bs,
                                                cmb)
        got = fa.decode_attention_paged(q, pk, pv, lengths, tables, hh)
        torch.cuda.synchronize()   # a fault of the dead row shows here
        pk0, pv0 = pk.nan_to_num(), pv.nan_to_num()
        want = fa._decode_paged_reference(q, pk0, pv0, lengths, tables, hh)
        tbl = tables.long().clamp(0, nb - 1)
        s, c = len(lens), cmb * bs
        dense = fa.decode_attention(q, pk0[tbl].reshape(s, c, hh * hd),
                                    pv0[tbl].reshape(s, c, hh * hd),
                                    lengths, hh)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got[:-1]).all()),
              "decode_attention_paged read a poisoned block")
        err = float((got[:-1] - want[:-1]).abs().max())
        print("[compare] decode_attention_paged S=%d H=%d D=%d BS=%d MB=%d "
              "NB=%d lengths %s: max_abs_err vs plain %.3g (tol %g); "
              "bitwise equal to decode_attention on the gathered cache"
              % (s, hh, hd, bs, cmb, nb, lens[:-1], err, KERNEL_ATOL))
        check(err <= KERNEL_ATOL,
              "decode_attention_paged disagrees with its plain version: %g"
              % err)
        check(torch.equal(got[:-1], dense[:-1]),
              "decode_attention_paged and decode_attention differ on the "
              "same logical rows")
        if hh == h:
            worst = err
    return worst


def phase_compare_paged_splits(rng):
    """B5's split boundaries: per pool dtype (float32, bfloat16) and
    (heads, D, BS) of (16, 128, 16) and (4, 64, 8), lengths at the plan's
    chunk - 1, chunk and chunk + 1 (with 2 chunks + 1 and 1), and one slot
    at the table's whole width with the others at 1; NaN-poisoned
    unreferenced blocks and an all-dead last row, as
    :func:`phase_compare_paged`; against the plain version and, bitwise,
    against B4 on the gathered cache. Each case runs again with the same
    logical rows in other blocks (the pool's blocks permuted, the tables
    renumbered to match): the live slots' outputs must be bitwise equal,
    as the split cuts and combines by logical row alone. Returns the
    worst error per dtype."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for dtype in (None, torch.bfloat16):
        for hh, hd, bs in ((FULL["num_heads"],
                            FULL["d_model"] // FULL["num_heads"],
                            BLOCK_SIZE), (4, 64, 8)):
            mb = CACHE_LEN // bs
            nb = SLOTS * mb
            chunk = fa._paged_plan(SLOTS, hh, hd, bs, mb).chunk
            for lens in ([chunk - 1, chunk, chunk + 1, 2 * chunk + 1, 1, 7,
                          300, 0], [mb * bs] + [1] * (SLOTS - 2) + [0]):
                q, pk, pv, lengths, tables = paged_case(
                    rng, lens, hh, hd, nb, bs, mb, dtype=dtype)
                got = fa.decode_attention_paged(q, pk, pv, lengths, tables,
                                                hh)
                torch.cuda.synchronize()   # a fault of the dead row shows
                perm = torch.from_numpy(rng.permutation(nb)).cuda()
                pk2, pv2 = torch.empty_like(pk), torch.empty_like(pv)
                pk2[perm], pv2[perm] = pk, pv
                live = (tables >= 0) & (tables < nb)
                tables2 = torch.where(
                    live, perm[tables.long().clamp(0, nb - 1)].int(), tables)
                got2 = fa.decode_attention_paged(q, pk2, pv2, lengths,
                                                 tables2, hh)
                check(torch.equal(got[:-1], got2[:-1]),
                      "decode_attention_paged's output moved when the same "
                      "rows sat in other blocks")
                pk0, pv0 = pk.nan_to_num(), pv.nan_to_num()
                want = fa._decode_paged_reference(q, pk0, pv0, lengths,
                                                  tables, hh)
                tbl = tables.long().clamp(0, nb - 1)
                c = mb * bs
                dense = fa.decode_attention(
                    q, pk0[tbl].reshape(SLOTS, c, hh * hd),
                    pv0[tbl].reshape(SLOTS, c, hh * hd), lengths, hh)
                torch.cuda.synchronize()
                kind = "bfloat16" if dtype else "float32"
                check(bool(torch.isfinite(got[:-1]).all()),
                      "decode_attention_paged %s read a poisoned block" % kind)
                err = float((got[:-1] - want[:-1]).abs().max())
                print("[compare] decode_attention_paged %s H=%d D=%d BS=%d "
                      "chunk %d lengths %s: max_abs_err vs plain %.3g (tol "
                      "%g); bitwise equal with the blocks permuted and to "
                      "decode_attention on the gathered cache"
                      % (kind, hh, hd, bs, chunk, lens[:-1], err,
                         KERNEL_ATOL))
                check(err <= KERNEL_ATOL,
                      "decode_attention_paged %s disagrees at its split "
                      "boundaries: %g" % (kind, err))
                check(torch.equal(got[:-1], dense[:-1]),
                      "decode_attention_paged %s and decode_attention differ "
                      "on the same logical rows" % kind)
                worst[kind] = max(worst[kind], err)
    return worst


def phase_compare_paged_verify(rng):
    """B5 at the speculative verify forward's shape (``MultiHeadAttention.
    verify_paged``): W = SPEC_K + 1 queries of one sequence, its table row
    repeated W times, lengths L + 1 ... L + W, for L = the plan's chunk - 3
    (the window across a chunk boundary) and each L of VERIFY_HISTS
    (across a block boundary, inside one block, ending at the table's
    whole width), on float32 and
    bfloat16 pools at the path's (H, D, BS, MB) with NaN-poisoned
    unreferenced blocks: against the plain version at KERNEL_ATOL, and
    each row bitwise equal to B5 called for that row alone (S = 1), the
    arithmetic of a decode step for a sequence at that length. Returns
    the worst error per dtype."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    h, d = FULL["num_heads"], FULL["d_model"] // FULL["num_heads"]
    bs, w = BLOCK_SIZE, SPEC_K + 1
    mb = CACHE_LEN // bs
    nb = SLOTS * mb
    chunk = fa._paged_plan(w, h, d, bs, mb).chunk
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for dtype in (None, torch.bfloat16):
        kind = "bfloat16" if dtype else "float32"
        for hist in (chunk - 3,) + VERIFY_HISTS:
            _, pk, pv, _, table = paged_case(rng, [hist + w], h, d, nb, bs,
                                             mb, dtype=dtype)
            q = torch.from_numpy(rng.standard_normal(
                (w, h * d), dtype=np.float32)).cuda()
            lengths = torch.arange(hist + 1, hist + w + 1, dtype=torch.int32,
                                   device="cuda")
            tables = table.expand(w, -1).contiguous()
            got = fa.decode_attention_paged(q, pk, pv, lengths, tables, h)
            alone = torch.cat([fa.decode_attention_paged(
                q[i:i + 1], pk, pv, lengths[i:i + 1], table, h)
                for i in range(w)])
            want = fa._decode_paged_reference(q, pk.nan_to_num(),
                                              pv.nan_to_num(), lengths,
                                              tables, h)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  "decode_attention_paged %s verify read a poisoned block"
                  % kind)
            err = float((got - want).abs().max())
            print("[compare] decode_attention_paged %s verify shape: %d "
                  "queries of one table row, lengths %d..%d: max_abs_err vs "
                  "plain %.3g (tol %g); every row bitwise equal to B5 on "
                  "that row alone: %s"
                  % (kind, w, hist + 1, hist + w, err, KERNEL_ATOL,
                     torch.equal(got, alone)))
            check(err <= KERNEL_ATOL, "decode_attention_paged %s disagrees "
                  "at the verify shape: %g" % (kind, err))
            check(torch.equal(got, alone), "decode_attention_paged %s: a "
                  "verify row differs from the same row alone" % kind)
            worst[kind] = max(worst[kind], err)
    return worst


def phase_compare_dense_splits(rng):
    """B4's split boundaries: per cache dtype (float32, bfloat16) and
    (heads, D) of (16, 128) and (4, 64), lengths at the plan's chunk - 1,
    chunk and chunk + 1 (with 2 chunks + 1, 1, 7, 300), and one slot at
    the cache's whole width with the others at 1; the last slot at length
    0 must come out exactly 0 (the plain version gives V's mean there).
    The live slots against the plain version; a second call, on a scratch
    filled with NaN, bitwise equal to the first (each partial the combine
    reads is written in the call); the counters read back 0 after each
    call. Returns the worst error per dtype."""
    import torch
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    worst = {"float32": 0.0, "bfloat16": 0.0}
    dev = torch.device("cuda", torch.cuda.current_device())
    for dtype in (torch.float32, torch.bfloat16):
        kind = str(dtype)[6:]
        for hh, hd in ((FULL["num_heads"], FULL["d_model"] // FULL["num_heads"]),
                       (4, 64)):
            plan = fa._split_plan(SLOTS, hh, hd, CACHE_LEN)
            chunk = plan.chunk
            for lens in ([chunk - 1, chunk, chunk + 1, 2 * chunk + 1, 1, 7,
                          300, 0], [CACHE_LEN] + [1] * (SLOTS - 2) + [0]):
                q = torch.from_numpy(rng.standard_normal(
                    (SLOTS, hh * hd), dtype=np.float32)).cuda()
                kc, vc = (torch.from_numpy(rng.standard_normal(
                    (SLOTS, CACHE_LEN, hh * hd), dtype=np.float32)).cuda()
                    .to(dtype) for _ in range(2))
                lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
                got = fa.decode_attention(q, kc, vc, lengths, hh)
                stream = _build.stream(dev)
                counters = _build.counters(dev, stream, plan.counters)
                torch.cuda.synchronize()
                clear = not counters[:plan.counters].any()
                _build.scratch(dev, stream, plan.scratch_bytes).fill_(255)
                again = fa.decode_attention(q, kc, vc, lengths, hh)
                want = fa.decode_attention_plain(q, kc, vc, lengths, hh)
                torch.cuda.synchronize()
                clear = clear and not counters[:plan.counters].any()
                err = float((got[:-1] - want[:-1]).abs().max())
                print("[compare] decode_attention %s H=%d D=%d chunk %d "
                      "lengths %s: max_abs_err vs plain %.3g (tol %g); the "
                      "length-0 slot exactly 0; a second call on a NaN "
                      "scratch bitwise equal; counters 0 after each call"
                      % (kind, hh, hd, chunk, lens, err, KERNEL_ATOL))
                check(err <= KERNEL_ATOL,
                      "decode_attention %s disagrees at its split boundaries:"
                      " %g" % (kind, err))
                check(not got[-1].any(),
                      "decode_attention gave a length-0 slot a nonzero output")
                check(torch.equal(got, again),
                      "decode_attention: two calls differ")
                check(clear, "decode_attention left a counter nonzero")
                worst[kind] = max(worst[kind], err)
                del kc, vc
    return worst


def quantized(rng, k, n):
    """A weight of the small-std LM's kind, armed: (int8 [k, n], f32 [n]
    scales) on the card, quantized as the session arms it."""
    import torch
    from paddle_tpu_torch.serving.quant import quantize_array
    w = rng.standard_normal((k, n), dtype=np.float32)
    w *= 0.02
    q, s = quantize_array(w, 1)
    return torch.from_numpy(q).cuda(), torch.from_numpy(s).cuda()


def phase_compare_int8(rng, wide_rng):
    """The int8 kernel against its plain version on the same card inputs,
    at every (m, k, n) of the serving and program paths and at ragged
    shapes, each x with an all-zero row: the contract is bitwise
    equality. INT8_RAGGED_WIDE, INT8_SPLIT_EDGES and PROGRAM_INT8_SHAPES
    draw from ``wide_rng``, so the phases after this one see the inputs
    they saw before those shapes were added."""
    import torch
    from paddle_tpu_torch.ops import quant_ops
    worst = 0.0
    cases = [(shape, rng) for shape in INT8_SHAPES + INT8_RAGGED] \
        + [(shape, wide_rng)
           for shape in INT8_RAGGED_WIDE + INT8_SPLIT_EDGES
           + PROGRAM_INT8_SHAPES]
    for (m, k, n), gen in cases:
        x = torch.from_numpy(gen.standard_normal((m, k), dtype=np.float32))
        x = x.cuda()
        if m > 1:
            x[m // 2] = 0.0
        wq, ws = quantized(gen, k, n)
        got = quant_ops.quant_matmul_2d(x, wq, ws)
        want = quant_ops.int8_matmul_plain(x, wq, ws)
        torch.cuda.synchronize()
        differ = int((got != want).sum())
        err = float((got - want).abs().max())
        plan = quant_ops._plan(m, k, n)
        split = "" if plan.tile >= 0 else ", %d k chunks of %d" % (
            plan.splits, plan.kc)
        print("[compare] int8_matmul m=%d k=%d n=%d%s max_abs_err=%.3g, %d "
              "differing elements (exact)" % (m, k, n, split, err, differ))
        check(differ == 0, "int8_matmul differs from its plain version at "
              "%s in %d elements" % ((m, k, n), differ))
        worst = max(worst, err)
    return worst


def phase_compare_bf16(rng):
    """The decode kernels on bfloat16 caches against their plain versions
    at the path's shapes (B5 with NaN-poisoned unreferenced blocks)."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    h, d = FULL["num_heads"], FULL["d_model"] // FULL["num_heads"]
    bf16 = torch.bfloat16
    lens = [1, 7, 129, 300, 512, 513, 1000, 1024]
    q = torch.from_numpy(rng.standard_normal((SLOTS, h * d),
                                             dtype=np.float32)).cuda()
    kc, vc = (torch.from_numpy(rng.standard_normal(
        (SLOTS, CACHE_LEN, h * d), dtype=np.float32)).cuda().to(bf16)
        for _ in range(2))
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = fa.decode_attention(q, kc, vc, lengths, h)
    torch.cuda.synchronize()
    err4 = float((got - fa.decode_attention_plain(q, kc, vc, lengths, h))
                 .abs().max())
    print("[compare] decode_attention bf16 cache S=%d C=%d H=%d D=%d "
          "max_abs_err=%.3g (tol %g)" % (SLOTS, CACHE_LEN, h, d, err4,
                                         KERNEL_ATOL))
    check(err4 <= KERNEL_ATOL, "decode_attention bf16 disagrees: %g" % err4)
    mb = -(-CACHE_LEN // BLOCK_SIZE)
    plens = [1, 16, 17, 100, 300, 513, 1024, 0]
    q, pk, pv, lengths, tables = paged_case(rng, plens, h, d, SLOTS * mb,
                                            BLOCK_SIZE, mb, dtype=bf16)
    got = fa.decode_attention_paged(q, pk, pv, lengths, tables, h)
    torch.cuda.synchronize()
    want = fa._decode_paged_reference(q, pk.nan_to_num(), pv.nan_to_num(),
                                      lengths, tables, h)
    check(bool(torch.isfinite(got[:-1]).all()),
          "decode_attention_paged bf16 read a poisoned block")
    err5 = float((got[:-1] - want[:-1]).abs().max())
    print("[compare] decode_attention_paged bf16 pools S=%d H=%d D=%d BS=%d "
          "MB=%d lengths %s max_abs_err=%.3g (tol %g)"
          % (SLOTS, h, d, BLOCK_SIZE, mb, plens[:-1], err5, KERNEL_ATOL))
    check(err5 <= KERNEL_ATOL,
          "decode_attention_paged bf16 disagrees: %g" % err5)
    return {"decode_attention bf16": err4,
            "decode_attention_paged bf16": err5}


def phase_small_lm(rng):
    """A small LM (head dim 128) on the card, kernels in the path, held
    against the same LM on the CPU (plain versions): prefill logits and
    eight teacher-forced decode steps."""
    import torch
    from paddle_tpu_torch.models.transformer import TransformerLM
    from paddle_tpu_torch.io import params_from_jax
    cfg = dict(vocab_size=512, d_model=256, num_heads=2, d_ff=512,
               num_layers=2, max_len=256)
    named = make_params(cfg, rng)
    models = {}
    for dev in ("cpu", "cuda"):
        m = TransformerLM(device=dev, **cfg)
        m.load_params(params_from_jax(named, device=dev))
        m.allocate_cache(2, 256)
        models[dev] = m
    n = 150
    prompt = np.full((1, 256), 1, np.int64)
    prompt[0, :n] = rng.integers(2, cfg["vocab_size"], n)
    worst = 0.0
    logits = {dev: m.prefill(torch.from_numpy(prompt).to(dev), n, 1).cpu()
              for dev, m in models.items()}
    worst = max(worst, float((logits["cpu"] - logits["cuda"]).abs().max()))
    tok = int(logits["cpu"].argmax())
    lengths = np.array([0, n], np.int32)
    for _ in range(8):
        toks = np.array([[0], [tok]], np.int64)
        logits = {dev: m.decode(torch.from_numpy(toks).to(dev),
                                torch.from_numpy(lengths).to(dev)).cpu()
                  for dev, m in models.items()}
        worst = max(worst, float((logits["cpu"][1] -
                                  logits["cuda"][1]).abs().max()))
        tok = int(logits["cpu"][1].argmax())
        lengths[1] += 1
    print("[small-lm] card vs CPU logits max_abs_err=%.3g (tol %g)"
          % (worst, LM_ATOL))
    check(worst <= LM_ATOL, "small LM on the card disagrees with the CPU")
    check(np.isfinite(logits["cuda"].numpy()).all(), "non-finite logits")


def phase_small_lm_paged(rng):
    """The small LM's paged sessions (prefix cache on) on the card and on
    the CPU, and its dense session on the card: the same prompts, two of
    them sharing a 100-token prefix and one repeated, must give the same
    greedy tokens everywhere and the same prefill log on both paged
    sessions."""
    from paddle_tpu_torch.io import params_from_jax
    from paddle_tpu_torch.models.transformer import transformer_lm_session
    from paddle_tpu_torch.serving import GenerationSession
    cfg = dict(vocab_size=512, d_model=256, num_heads=2, d_ff=512,
               num_layers=2, max_len=256)
    named = make_params(cfg, rng)
    sessions = {}
    for name, dev, paged in (("cpu paged", "cpu", True),
                             ("card paged", "cuda", True),
                             ("card dense", "cuda", False)):
        spec = transformer_lm_session(
            slots=2, cache_len=256, prompt_buckets=(64, 256), eos_id=1,
            device=dev, paged=paged, block_size=BLOCK_SIZE,
            prefix_cache=True, **cfg)
        sessions[name] = GenerationSession(spec,
                                           params_from_jax(named, device=dev))
    shared = rng.integers(2, cfg["vocab_size"], 100)
    prompts = [np.concatenate([shared, rng.integers(2, cfg["vocab_size"], n)])
               for n in (30, 50)]
    prompts.append(prompts[0])
    for p in prompts:
        outs = {name: sess.generate(p, max_new_tokens=8, eos_id=-1)
                for name, sess in sessions.items()}
        check(len(set(map(tuple, outs.values()))) == 1,
              "paged small LM tokens differ: %s" % outs)
    logs = [sessions[k].prefill_log for k in ("cpu paged", "card paged")]
    print("[small-lm] paged on the card == paged on the CPU == dense on the "
          "card, greedy tokens of %d prompts; prefill log %s"
          % (len(prompts), logs[1]))
    check(logs[0] == logs[1] and logs[1][1][1] == 96,
          "paged prefill logs differ: %s" % logs)
    for sess in sessions.values():
        sess.close()


def phase_small_lm_quant(rng):
    """The small LM with int8 weights and bfloat16 caches on the card
    against the same LM on the CPU, dense and paged: prefill logits and
    eight teacher-forced decode steps (tokens from the CPU), within
    LM_INT8_STEPS head quantization steps; the count of equal greedy
    tokens is printed. Returns the dense card run's decode-kernel
    launches (bfloat16 caches)."""
    import torch
    from paddle_tpu_torch.io import params_from_jax
    from paddle_tpu_torch.models.transformer import TransformerLM
    from paddle_tpu_torch.serving.quant import arm_quant_compute
    cfg = dict(vocab_size=512, d_model=256, num_heads=2, d_ff=512,
               num_layers=2, max_len=256)
    named = make_params(cfg, rng)
    n, bs = 150, BLOCK_SIZE
    prompt = np.full((1, 256), 1, np.int64)
    prompt[0, :n] = rng.integers(2, cfg["vocab_size"], n)
    mb = cfg["max_len"] // bs
    nb = 2 * mb
    tables = np.full((2, mb), nb, np.int32)    # slot 0 inactive: all dead
    tables[1] = rng.permutation(nb)[:mb]
    dec_launches = 0
    for paged in (False, True):
        models = {}
        for dev in ("cpu", "cuda"):
            m = TransformerLM(device=dev, **cfg)
            m.load_params(params_from_jax(named, device=dev))
            arm_quant_compute(m)
            if paged:
                m.allocate_pools(nb, bs, torch.bfloat16)
            else:
                m.allocate_cache(2, cfg["max_len"], torch.bfloat16)
            models[dev] = m
        # one quantization step of the LM head's input: a layer-norm
        # output has |z| <= sqrt(d - 1) * max|scale| + max|shift|
        cpu = models["cpu"]
        amax = (cfg["d_model"] - 1) ** 0.5 * float(cpu.ln_f_w.abs().max()) \
            + float(cpu.ln_f_b.abs().max())
        tol = LM_INT8_STEPS * amax * float(cpu.lm_head_scale.max())
        reset_launches()

        def prefill(m, dev):
            tok = torch.from_numpy(prompt).to(dev)
            if not paged:
                return m.prefill(tok, n, 1)
            pix = torch.arange(cfg["max_len"], device=dev)
            return m.prefill_paged(tok, n, 0, pix,
                                   torch.from_numpy(tables[1]).to(dev))

        logits = {dev: prefill(m, dev).cpu() for dev, m in models.items()}
        worst = float((logits["cpu"] - logits["cuda"]).abs().max())
        equal = int(logits["cpu"].argmax() == logits["cuda"].argmax())
        tok = int(logits["cpu"].argmax())
        lengths = np.array([0, n], np.int32)
        for _ in range(8):
            toks = np.array([[0], [tok]], np.int64)
            logits = {dev: m.decode(
                torch.from_numpy(toks).to(dev),
                torch.from_numpy(lengths).to(dev),
                torch.from_numpy(tables).to(dev) if paged else None).cpu()
                for dev, m in models.items()}
            worst = max(worst, float((logits["cpu"][1] -
                                      logits["cuda"][1]).abs().max()))
            equal += int(logits["cpu"][1].argmax() ==
                         logits["cuda"][1].argmax())
            tok = int(logits["cpu"][1].argmax())
            lengths[1] += 1
        torch.cuda.synchronize()
        launches = read_launches()
        layout = "paged" if paged else "dense"
        print("[small-lm] int8 weights, bf16 %s caches: card vs CPU logits "
              "max_abs_err=%.3g (tol %.3g = %d head steps of %.3g); equal "
              "greedy tokens %d of 9; card launches %s"
              % (layout, worst, tol, LM_INT8_STEPS, tol / LM_INT8_STEPS,
                 equal, launches))
        check(worst <= tol, "int8/bf16 small LM (%s) on the card disagrees "
              "with the CPU: %g > %g" % (layout, worst, tol))
        check(np.isfinite(logits["cuda"].numpy()).all(), "non-finite logits")
        check(launches["int8_matmul"] == 9 * (6 * cfg["num_layers"] + 1),
              "int8 launches %d" % launches["int8_matmul"])
        dec = "decode_attention_paged" if paged else "decode_attention"
        check(launches[dec] == 8 * cfg["num_layers"],
              "%s launches %d" % (dec, launches[dec]))
        if not paged:
            dec_launches = launches[dec]
    return dec_launches


def phase_serve(sess, rng):
    """Serve the requests through the scheduler with every launch count
    at 0 just before; returns the counts, the served lengths, the prompts
    and the outputs."""
    import torch
    from paddle_tpu_torch.serving import GenerationScheduler
    prompts = [rng.integers(2, FULL["vocab_size"], n) for n in PROMPT_LENS]
    sched = GenerationScheduler(sess, autostart=False)
    reset_launches()
    prefills0, steps0 = sess.prefills, sess.steps
    t0 = time.perf_counter()
    futs = [sched.submit(p, max_new_tokens=NEW_TOKENS, eos_id=-1)
            for p in prompts]
    sched.start()
    outs = [f.result(timeout=600) for f in futs]
    sched.drain(timeout=60)
    torch.cuda.synchronize()
    launches = read_launches()
    wall = time.perf_counter() - t0
    admissions = sess.prefills - prefills0
    steps = sess.steps - steps0
    layers = FULL["num_layers"]
    print("[serve] %d requests, %d admissions, %d decode steps in %.2f s; "
          "launches %s" % (len(prompts), admissions, steps, wall, launches))
    for p, out in zip(prompts, outs):
        check(len(out) == NEW_TOKENS, "request of %d tokens returned %d"
              % (p.size, len(out)))
        check(((out >= 0) & (out < FULL["vocab_size"])).all(),
              "token out of the vocabulary")
    check(admissions == len(prompts), "admissions %d" % admissions)
    check(launches["flash_attention"] == layers * admissions > 0,
          "flash launches %d != %d x %d admissions"
          % (launches["flash_attention"], layers, admissions))
    check(launches["decode_attention"] == layers * steps > 0,
          "decode launches %d != %d x %d steps"
          % (launches["decode_attention"], layers, steps))
    check(launches["decode_attention_paged"] == 0
          and launches["int8_matmul"] == 0,
          "the dense f32 path launched the paged decode or int8 kernel")
    final = [p.size + NEW_TOKENS - 1 for p in prompts]
    return launches, final, prompts, outs


def paged_prompts(rng):
    """The paged cell's traffic: a 192-token system prompt with three
    suffixes, an exact repeat of the first request and one unrelated
    prompt. Returns (system prompt, the five prompts)."""
    v = FULL["vocab_size"]
    system = rng.integers(2, v, SYSTEM_LEN)
    prompts = [np.concatenate([system, rng.integers(2, v, n)])
               for n in SUFFIX_LENS]
    prompts.append(prompts[0].copy())
    prompts.append(rng.integers(2, v, UNRELATED_LEN))
    return system, prompts


def serve_paged(sess, prompts, tag, seeds=None, plain=True):
    """Serve ``prompts`` through the scheduler with every launch count at
    0 just before, request i keyed by ``seeds[i]`` when given. All are
    queued before the dispatcher starts, so they are admitted in order:
    the first and the unrelated prompt miss the prefix cache; the other
    two suffixes share the system prompt's 12 blocks; the repeat shares
    the first request's 227 tokens (the match stops at n - 1) and copies
    its partial last block. Checks what does not depend on the weights'
    dtype (with ``plain``, also that every decode step went through the
    paged kernel and no dense kernel ran; a speculative session's caller
    checks its own counts) and returns (launches, outputs, decode
    steps)."""
    import torch
    from paddle_tpu_torch.serving import GenerationScheduler
    sched = GenerationScheduler(sess, autostart=False)
    stats0 = sess.prefix_stats()
    log0 = len(sess.prefill_log)
    reset_launches()
    prefills0, steps0 = sess.prefills, sess.steps
    t0 = time.perf_counter()
    futs = [sched.submit(p, max_new_tokens=NEW_TOKENS, eos_id=-1,
                         seed=None if seeds is None else seeds[i])
            for i, p in enumerate(prompts)]
    sched.start()
    outs = [f.result(timeout=600) for f in futs]
    sched.drain(timeout=60)
    torch.cuda.synchronize()
    launches = read_launches()
    wall = time.perf_counter() - t0
    admissions = sess.prefills - prefills0
    steps = sess.steps - steps0
    stats = {k: sess.prefix_stats()[k] - stats0[k]
             for k in ("hits", "misses", "shared_tokens", "cows")}
    log = sess.prefill_log[log0:]
    print("[%s] %d requests, %d admissions, %d decode steps in %.2f s; "
          "prefill log (bucket, shared, window) %s; prefix %s; pool %s; "
          "launches %s" % (tag, len(prompts), admissions, steps, wall, log,
                           stats, sess.pool_stats(), launches))
    for p, out in zip(prompts, outs):
        check(len(out) == NEW_TOKENS, "request of %d tokens returned %d"
              % (p.size, len(out)))
        check(((out >= 0) & (out < FULL["vocab_size"])).all(),
              "token out of the vocabulary")
    check(admissions == len(prompts), "admissions %d" % admissions)
    check([w for _, _, w in log] == [228, 108, 308, 1, 100],
          "prefill windows %s" % log)
    check(stats["hits"] == 3 and stats["misses"] == 2
          and stats["shared_tokens"] == 611 and stats["cows"] >= 1,
          "prefix counters %s" % stats)
    check(not plain or launches["decode_attention_paged"] ==
          FULL["num_layers"] * steps > 0,
          "paged decode launches %d != %d x %d steps"
          % (launches["decode_attention_paged"], FULL["num_layers"], steps))
    check(not plain or (launches["flash_attention"] == 0
                        and launches["decode_attention"] == 0),
          "the paged path launched a dense kernel: %s" % launches)
    try:
        sess.check_pool_invariant()
    except AssertionError as exc:
        raise SmokeFailure("pool books: %s" % exc) from None
    return launches, outs, steps


def peak_above(fn):
    """``fn()``'s result and the card's peak allocation while it ran
    above what was allocated before it (bytes)."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def phase_paged_serve(sess, prompts):
    """The paged cell's five requests on the float32 session: no int8
    launch, and the repeat's tokens equal the first request's. Returns
    the counts, the outputs, the served lengths and the cell's peak
    allocation above what was allocated before it."""
    (launches, outs, _), peak = peak_above(
        lambda: serve_paged(sess, prompts, "paged-serve"))
    check((outs[3] == outs[0]).all(),
          "the repeated request's tokens differ from the first's")
    check(launches["int8_matmul"] == 0, "the f32 path launched int8_matmul")
    final = [p.size + NEW_TOKENS - 1 for p in prompts]
    return launches, outs, final, peak


def phase_quant_serve(quant, f32, prompts, f32_outs):
    """The paged cell's five requests on the int8/bf16 session: every
    armed product through the int8 kernel (73 per admission and per
    step), every decode through the paged kernel; the armed weights
    int8; bfloat16 pools at half the f32 session's bytes per block. The
    repeat's tokens against the first request's, and the greedy tokens'
    agreement with the f32 session's, are printed, not gated: random
    weights leave tiny margins that one int8 rounding step can flip."""
    import torch
    armed = quant._quant_armed
    weights = [quant.model.mul_weight(name) for name in armed]
    check(len(armed) == INT8_PER_PASS and all(
        w.dtype == torch.int8 and s is not None for w, s in weights),
        "armed weights: %d names, dtypes %s"
        % (len(armed), sorted({str(w.dtype) for w, _ in weights})))
    nbytes = sum(w.numel() for w, _ in weights)
    sbytes = sum(s.numel() * 4 for _, s in weights)
    print("[quant-serve] %d armed weights: %d int8 bytes (%.3f GB) and %d "
          "scale bytes; pools %s" % (len(armed), nbytes, nbytes / 1e9,
                                     sbytes, quant.model.caches[0][0].dtype))
    launches, outs, steps = serve_paged(quant, prompts, "quant-serve")
    check(launches["int8_matmul"] == INT8_PER_PASS * (len(prompts) + steps),
          "int8 launches %d != %d x (%d admissions + %d steps)"
          % (launches["int8_matmul"], INT8_PER_PASS, len(prompts), steps))
    b32 = f32.pool_stats()["bytes_per_block"]
    b16 = quant.pool_stats()["bytes_per_block"]
    check(2 * b16 == b32, "bytes per block %d, f32 %d" % (b16, b32))
    agree = np.mean(np.concatenate(outs) == np.concatenate(f32_outs))
    print("[quant-serve] repeat's tokens equal the first's: %s; greedy "
          "tokens equal to the f32 paged session's: %.4f (%d of %d); bytes "
          "per block %d (f32 %d)"
          % (bool((outs[3] == outs[0]).all()), agree,
             int(round(agree * len(prompts) * NEW_TOKENS)),
             len(prompts) * NEW_TOKENS, b16, b32))
    final = [p.size + NEW_TOKENS - 1 for p in prompts]
    return launches, final, outs


def phase_paged_logits(paged, dense, system, rng):
    """The paged model's prefill logits for one 300-token prompt whose
    first 192 tokens are the system prompt, as a prefix miss (the whole
    prompt, bucket 512) and as a hit (the 108-token window after the
    cached 192, bucket 128, reading the rows the miss wrote), against the
    dense model's prefill of the same prompt."""
    import torch
    prompt = np.concatenate([system, rng.integers(2, FULL["vocab_size"],
                                                  108)])
    n, spec = prompt.size, paged.spec
    blocks = [paged.pool.alloc() for _ in range(-(-n // BLOCK_SIZE))]
    tab = np.full(spec.max_blocks, spec.num_blocks, np.int32)
    tab[:len(blocks)] = blocks

    def window(start, bucket):
        w = n - start
        padded = np.full((1, bucket), 1, np.int64)
        padded[0, :w] = prompt[start:]
        pix = np.clip(start + np.arange(bucket), 0, spec.max_len - 1)
        return paged.model.prefill_paged(
            torch.from_numpy(padded).cuda(), w, start,
            torch.from_numpy(pix).cuda(), torch.from_numpy(tab).cuda())

    try:
        miss = window(0, BUCKETS[-1])
        hit = window(SYSTEM_LEN, BUCKETS[0])
    finally:
        for b in blocks:
            paged.pool.decref(b)
    padded = np.full((1, BUCKETS[-1]), 1, np.int64)
    padded[0, :n] = prompt
    want = dense.model.prefill(torch.from_numpy(padded).cuda(), n,
                               dense.free_slots()[0])
    errs = {name: float((got - want).abs().max())
            for name, got in (("miss", miss), ("hit", hit))}
    print("[paged-serve] prefill logits of a %d-token prompt, paged vs "
          "dense: max_abs_err %s (tol %g); argmax %d / %d / %d"
          % (n, {k: "%.3g" % e for k, e in errs.items()}, PAGED_LOGITS_ATOL,
             int(miss.argmax()), int(hit.argmax()), int(want.argmax())))
    check(max(errs.values()) <= PAGED_LOGITS_ATOL,
          "paged prefill logits disagree with dense: %s" % errs)
    check(int(miss.argmax()) == int(hit.argmax()) == int(want.argmax()),
          "paged prefill picks another token than dense")


def phase_paged_latency(paged, dense, system, rng, quant):
    """TTFT of a 300-token prompt on the paged sessions (float32, and
    int8 weights with bf16 pools) as a prefix hit (the 192-token system
    prompt cached: window 108, bucket 128) and as a miss (bucket 512),
    and on the dense session (bucket 512); then the decode step with 8
    active slots on each, in turns. Host clock around work that ends in
    tokens read back; medians of LATENCY_ROUNDS."""
    import torch
    v = FULL["vocab_size"]
    cases = []
    for label, sess in (("paged", paged), ("int8", quant)):
        cases += [("%s hit" % label, sess, lambda: np.concatenate(
                      [system, rng.integers(2, v, 108)])),
                  ("%s miss" % label, sess, lambda: rng.integers(2, v, 300))]
    cases.append(("dense", dense, lambda: rng.integers(2, v, 300)))
    ttft = {name: [] for name, _, _ in cases}
    for _ in range(LATENCY_ROUNDS):
        for name, sess, make in cases:
            prompt = make()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            slot, _ = sess.admit(prompt)
            ttft[name].append((time.perf_counter() - t0) * 1e3)
            if sess.paged:
                want = (128, 192, 108) if name.endswith("hit") \
                    else (512, 0, 300)
                check(sess.prefill_log[-1] == want,
                      "%s prefill %s" % (name, sess.prefill_log[-1]))
            sess.retire(slot)
    stepped = (("paged step", paged), ("int8 step", quant),
               ("dense step", dense))
    for _, sess in stepped:
        for i in range(SLOTS):
            sess.admit(rng.integers(2, v, 64 + 56 * i))
        for _ in range(3):
            sess.step()
    steps = {name: [] for name, _ in stepped}
    for _ in range(LATENCY_ROUNDS):
        for name, sess in stepped:
            t0 = time.perf_counter()
            for _ in range(16):
                sess.step()
            steps[name].append((time.perf_counter() - t0) * 1e3 / 16)
    for _, sess in stepped:
        for s in range(SLOTS):
            sess.retire(s)
    runs = dict(ttft, **steps)
    med = {k: sorted(t)[len(t) // 2] for k, t in runs.items()}
    print("[latency] 300-token prompt TTFT ms (median of %d): paged hit "
          "%.3f (window 108), paged miss %.3f, int8/bf16 hit %.3f, int8/bf16 "
          "miss %.3f, dense %.3f; decode step with %d active slots ms "
          "(median of %d rounds of 16): paged %.3f, int8/bf16 paged %.3f, "
          "dense %.3f; all runs %s"
          % (LATENCY_ROUNDS, med["paged hit"], med["paged miss"],
             med["int8 hit"], med["int8 miss"], med["dense"], SLOTS,
             LATENCY_ROUNDS, med["paged step"], med["int8 step"],
             med["dense step"],
             {k: [round(x, 3) for x in t] for k, t in runs.items()}))


def policy_sessions(sess, paged, quant, paged_kw):
    """The decode-policy sessions of the flagship LM, each on the weights
    of an existing session by reference (no copy; the int8 one on the
    armed session's int8 tensors): sampled dense and paged, speculative
    greedy and sampled (the default 1-layer self-draft), speculative
    greedy on int8 weights with bf16 caches, and three constrained ones
    (the number-list grammar, greedy and sampled; a grammar that dies);
    and, so that full width exercises the accepting branch, speculative
    sessions whose draft is the whole target (all its layers, shared):
    greedy on f32 and on int8/bf16, and sampled by SPEC_SAMPLE_KNOBS
    beside a plain session sampled by them."""
    from paddle_tpu_torch.models.transformer import transformer_lm_session
    from paddle_tpu_torch.serving import GenerationSession
    from paddle_tpu_torch.serving.decoding import DecodePolicy, DFAConstraint
    v = FULL["vocab_size"]
    dense_kw = {k: paged_kw[k] for k in ("slots", "cache_len",
                                         "prompt_buckets", "eos_id",
                                         "device")}
    dense_kw.update(FULL)

    def build(base, policy, arm=False, **kw):
        spec = transformer_lm_session(decode_policy=policy, **dict(
            paged_kw if base is not sess else dense_kw, **kw))
        return GenerationSession(spec, base.model.reference_state(),
                                 arm_quant=arm, share=True)

    grammar, dead = number_grammar(v)
    return {
        "sample dense": build(sess, DecodePolicy("sample", **SAMPLE_KNOBS)),
        "sample": build(paged, DecodePolicy("sample", **SAMPLE_KNOBS)),
        "spec": build(paged, DecodePolicy(speculate_k=SPEC_K)),
        "spec sample": build(paged, DecodePolicy(
            "sample", speculate_k=SPEC_K, **SAMPLE_KNOBS)),
        "spec full draft": build(paged, DecodePolicy(
            speculate_k=SPEC_K, draft=dict(num_layers=FULL["num_layers"]))),
        "spec int8": build(quant, DecodePolicy(speculate_k=SPEC_K), arm=True,
                           dtype="bfloat16"),
        "spec int8 full draft": build(quant, DecodePolicy(
            speculate_k=SPEC_K, draft=dict(num_layers=FULL["num_layers"])),
            arm=True, dtype="bfloat16"),
        "sample top2": build(paged, DecodePolicy("sample",
                                                 **SPEC_SAMPLE_KNOBS)),
        "spec sample full draft": build(paged, DecodePolicy(
            "sample", speculate_k=SPEC_K,
            draft=dict(num_layers=FULL["num_layers"]), **SPEC_SAMPLE_KNOBS)),
        "constrain": build(paged, DecodePolicy(constraint=grammar)),
        "constrain sample": build(paged, DecodePolicy(
            "sample", constraint=grammar, **SAMPLE_KNOBS)),
        "dead end": build(paged, DecodePolicy(
            constraint=DFAConstraint(dead))),
    }


def number_grammar(v):
    """A number-list grammar over the full vocabulary, as a DFA, and a
    grammar that dies after its first token (transitions only). Token
    classes: 10 open brackets, 100 digits, 10 commas, 10 spaces, 10
    close brackets, EOS (id 1). ``[`` then numbers of 1 to 3 digits
    separated by a comma (and optionally a space), ``]``, then EOS
    repeated; 9 states with 10 to 120 legal tokens each (EOS alone after
    the list)."""
    from paddle_tpu_torch.serving.decoding import DFAConstraint
    cls = {name: range(lo, lo + n) for name, lo, n in (
        ("open", 100, 10), ("digit", 1000, 100), ("comma", 200, 10),
        ("space", 300, 10), ("close", 400, 10))}
    check(max(r[-1] for r in cls.values()) < v, "grammar past the vocab")

    def to(state, *names):
        return {t: state for n in names for t in cls[n]}
    eos = {1: 9}
    t = {8: to(0, "open"),                    # start: "["
         0: to(1, "digit"),                   # a number's first digit
         1: {**to(2, "digit"), **to(4, "comma"), **to(7, "close")},
         2: {**to(3, "digit"), **to(4, "comma"), **to(7, "close")},
         3: {**to(4, "comma"), **to(7, "close")},
         4: {**to(1, "digit"), **to(5, "space")},
         5: to(1, "digit"),
         7: eos, 9: eos}
    return DFAConstraint(t, start=8), {0: {tok: 1 for tok in cls["digit"]},
                                      1: {}}


def gap_at(sess, history, seed=None, knobs=SAMPLE_KNOBS):
    """The top-two gap of what the policy compares at the token after
    ``history``: the logits (greedy), or the logits filtered and tempered
    by ``knobs`` plus the token's Gumbel noise (sampled, keyed by
    ``seed``), from a prefill of the whole
    history on the paged session ``sess`` in windows of the largest
    bucket (its blocks taken from the pool and handed back)."""
    import torch
    from paddle_tpu_torch.ops import decoding_ops, random_ops
    spec = sess.spec
    n, big = history.size, BUCKETS[-1]
    blocks = [sess.pool.alloc() for _ in range(-(-n // BLOCK_SIZE))]
    tab = np.full(spec.max_blocks, spec.num_blocks, np.int32)
    tab[:len(blocks)] = blocks
    try:
        for start in range(0, n, big):
            w = min(big, n - start)
            padded = np.full((1, big), 1, np.int64)
            padded[0, :w] = history[start:start + w]
            pix = np.clip(start + np.arange(big), 0, spec.max_len - 1)
            logits = sess.model.prefill_paged(
                torch.from_numpy(padded).cuda(), w, start,
                torch.from_numpy(pix).cuda(), torch.from_numpy(tab).cuda())
    finally:
        for b in blocks:
            sess.pool.decref(b)
    x = logits.float()
    if seed is not None:
        x = decoding_ops.filtered_logits(x, **knobs)
        key = random_ops.decoding_key(torch.tensor([seed]), torch.tensor([n]),
                                      device=x.device)
        x = x + random_ops.gumbel(key, x.shape[1])
    top = torch.topk(x[0], 2).values
    return float(top[0] - top[1])


def near_tie_rule(tag, base, outs, prompts, gap_sess, seeds=None,
                  knobs=SAMPLE_KNOBS):
    """Streams ``outs`` against ``base``: equal, or first differing at a
    position whose top-two gap (``gap_at``) is within NEAR_TIE. Returns
    the number of equal streams and prints every divergence."""
    same = 0
    for i, (p, a, b) in enumerate(zip(prompts, outs, base)):
        if np.array_equal(a, b):
            same += 1
            continue
        pos = int(np.flatnonzero(np.asarray(a) != np.asarray(b))[0])
        hist = np.concatenate([p, np.asarray(b[:pos], np.int64)])
        gap = gap_at(gap_sess, hist, None if seeds is None else seeds[i],
                     knobs)
        print("[%s] request %d diverges at token %d (sequence index %d): "
              "top-two gap %.3g (near-tie limit %g)"
              % (tag, i, pos, hist.size, gap, NEAR_TIE))
        check(gap <= NEAR_TIE, "%s: request %d diverges at token %d with "
              "a top-two gap of %.3g" % (tag, i, pos, gap))
    return same


def phase_compare_sample(rng):
    """``sample_from_logits`` on the card against the same function on
    the CPU at [8, V] logits from the seed, over SAMPLE_PAIRS (seed,
    step) pairs, 8 a call, under each of SAMPLE_GRID's settings: the key
    words, random bits and uniforms bitwise, the Gumbel noise within
    GUMBEL_ULPS ulp at max(|g|, 1), the tokens equal, both with the keys
    derived on the card and with keys derived on the host and sent (the
    sessions' route, ``sample_from_keys``). Launches nothing counted (no
    kernel: the sampling is torch ops)."""
    import torch
    from paddle_tpu_torch.ops import decoding_ops, random_ops
    v = FULL["vocab_size"]
    logits = torch.from_numpy(2.0 * rng.standard_normal((SLOTS, v),
                                                        dtype=np.float32))
    mask = np.where(rng.random((SLOTS, v)) < 0.5, decoding_ops.NEG_INF,
                    0.0).astype(np.float32)
    mask = torch.from_numpy(mask)
    seeds = rng.integers(0, 2 ** 31, SAMPLE_PAIRS)
    steps = rng.integers(0, 2 * FULL["max_len"], SAMPLE_PAIRS)
    counts = {"keys": 0, "bits": 0, "uniform": 0}
    gumbel_equal = 0
    gumbel_ulps, tokens = 0.0, {name: 0 for name, _, _ in SAMPLE_GRID}
    for c in range(0, SAMPLE_PAIRS, SLOTS):
        sd = torch.from_numpy(seeds[c:c + SLOTS])
        st = torch.from_numpy(steps[c:c + SLOTS])
        kc = random_ops.decoding_key(sd, st)
        kg = random_ops.decoding_key(sd.cuda(), st.cuda())
        counts["keys"] += int((kg.cpu() == kc).all(-1).sum())
        counts["bits"] += int((random_ops.random_bits(kg, v).cpu() ==
                               random_ops.random_bits(kc, v)).all(-1).sum())
        uc = random_ops.uniform(kc, v, minval=random_ops.F32_TINY)
        ug = random_ops.uniform(kg, v, minval=random_ops.F32_TINY).cpu()
        counts["uniform"] += int((ug.view(torch.int32) ==
                                  uc.view(torch.int32)).all(-1).sum())
        gc = random_ops.gumbel(kc, v).double()
        gg = random_ops.gumbel(kg, v).cpu().double()
        gumbel_ulps = max(gumbel_ulps, float(
            ((gg - gc).abs() / (2.0 ** -23 * gc.abs().clamp(min=1.0)))
            .max()))
        gumbel_equal += int((gg == gc).all(-1).sum())
        for name, knobs, masked in SAMPLE_GRID:
            m = mask if masked else None
            want = decoding_ops.decode_sample(logits, sd, st, m, **knobs)
            got = decoding_ops.decode_sample(
                logits.cuda(), sd.cuda(), st.cuda(),
                None if m is None else m.cuda(), **knobs).cpu()
            # the sessions' route: keys derived on the host, sent
            lg = logits.cuda() if m is None else (logits + m).cuda()
            hosted = decoding_ops.sample_from_keys(
                lg, kc.cuda(), **knobs).cpu()
            tokens[name] += int(((got == want) & (hosted == want)).sum())
            if masked:
                check(bool((m[torch.arange(SLOTS), want] == 0).all()),
                      "a masked draw took a banned token")
    print("[compare] sample: %d (seed, step) pairs at [%d, %d]: key words "
          "%d, random bits %d, uniforms %d rows bitwise equal card to CPU; "
          "Gumbel noise (float64, rounded once) %d rows bitwise equal, max "
          "%.3g ulp at max(|g|, 1) (limit %d); tokens equal, keys on the "
          "card and keys from the host, %s of %d each"
          % (SAMPLE_PAIRS, SLOTS, v, counts["keys"], counts["bits"],
             counts["uniform"], gumbel_equal, gumbel_ulps, GUMBEL_ULPS,
             tokens, SAMPLE_PAIRS))
    check(all(n == SAMPLE_PAIRS for n in counts.values()),
          "random bits differ card to CPU: %s" % counts)
    check(gumbel_ulps <= GUMBEL_ULPS, "Gumbel noise %.3g ulp" % gumbel_ulps)
    check(all(n == SAMPLE_PAIRS for n in tokens.values()),
          "sampled tokens differ card to CPU: %s" % tokens)


def serve_seeded(sess, prompts, seeds, new=NEW_TOKENS):
    """Serve ``prompts`` through a scheduler, request i keyed by
    ``seeds[i]``; returns the outputs."""
    from paddle_tpu_torch.serving import GenerationScheduler
    sched = GenerationScheduler(sess, autostart=False)
    futs = [sched.submit(p, max_new_tokens=new, eos_id=-1, seed=s)
            for p, s in zip(prompts, seeds)]
    sched.start()
    outs = [f.result(timeout=600) for f in futs]
    sched.drain(timeout=60)
    return outs


def phase_sample_serve(sess, prompts):
    """The paged cell's five requests on the sampled f32 paged session
    (SAMPLE_KNOBS), keyed by SAMPLE_SEEDS: every decode step through B5
    and no other kernel; a second pass with the same seeds gives the same
    streams; another seed another stream; prompt + the first REPLAY_CUT
    tokens re-admitted with the stream's seed continues it token for
    token (the replay contract). Returns the outputs."""
    launches, outs, steps = serve_paged(sess, prompts, "sample-serve",
                                        seeds=SAMPLE_SEEDS)
    check(launches["int8_matmul"] == 0, "the f32 path launched int8_matmul")
    again = serve_seeded(sess, prompts, SAMPLE_SEEDS)
    repeat = sum(bool(np.array_equal(a, b)) for a, b in zip(outs, again))
    other = serve_seeded(sess, prompts[:1], (SAMPLE_SEEDS[0] + 1000,))[0]
    replayed = []
    for i in (0, 2):
        hist = np.concatenate([prompts[i], outs[i][:REPLAY_CUT]])
        slot, first = sess.admit(hist, seed=SAMPLE_SEEDS[i])
        cont = [first]
        while len(cont) < NEW_TOKENS - REPLAY_CUT:
            cont.append(sess.step()[slot])
        sess.retire(slot)
        replayed.append(bool(np.array_equal(cont, outs[i][REPLAY_CUT:])))
    print("[sample-serve] policy %s, seeds %s: second pass identical %d of "
          "%d; seed %d differs from seed %d: %s; replays of prompt + %d "
          "tokens continue the stream: %s; first tokens %s"
          % (sess.policy.fingerprint(), SAMPLE_SEEDS, repeat, len(prompts),
             SAMPLE_SEEDS[0] + 1000, SAMPLE_SEEDS[0],
             not np.array_equal(other, outs[0]), REPLAY_CUT, replayed,
             [o[:6].tolist() for o in outs]))
    check(repeat == len(prompts), "a second pass with the same seeds "
          "gave another stream")
    check(not np.array_equal(other, outs[0]),
          "another seed gave the same stream")
    check(all(replayed), "a replay did not continue its stream: %s"
          % replayed)
    sess.check_pool_invariant()
    return outs


def phase_spec_serve(spec, prompts, base, gap_sess, tag, seeds=None,
                     int8=False, knobs=SAMPLE_KNOBS, accepting=False):
    """The paged cell's five requests on a speculative session: the
    streams against the plain session's ``base`` under the near-tie rule;
    the pool's books; drafted, accepted and verify counts; the draft's B2
    and B4 launches against its admissions and steps, the target's B5
    against its plain steps and verify forwards (each attends through
    B5), and with ``int8`` every armed product of the
    target (73 an admission, a plain step and a verify forward) and of
    the draft (7 an admission and a step for the 1-layer self-draft, 73
    for the whole target) through B3, the draft holding the target's int8
    tensors and no float32 copy of them. ``knobs`` are the sampled
    policy's, for the near-tie gaps; with ``accepting``, some draft must
    be accepted, so that verify rows past the first decide tokens."""
    import torch
    from paddle_tpu_torch.models.transformer import lm_mul_weight_names
    d = spec.draft
    dl = d.model.num_layers
    d0 = (d.prefills, d.steps)
    v0 = (spec.verifies, spec.spec_drafted, spec.spec_accepted,
          spec.spec_rounds)
    launches, outs, steps = serve_paged(spec, prompts, tag, seeds=seeds,
                                        plain=False)
    dpre, dsteps = d.prefills - d0[0], d.steps - d0[1]
    verifies, drafted, accepted, rounds = (
        a - b for a, b in zip((spec.verifies, spec.spec_drafted,
                               spec.spec_accepted, spec.spec_rounds), v0))
    same = near_tie_rule(tag, base, outs, prompts, gap_sess, seeds, knobs)
    print("[%s] %d rounds, %d verify forwards, %d drafted, %d accepted "
          "(accept rate %.4f), %d plain steps; draft: %d layer(s), %d "
          "admissions, %d steps; streams equal to plain decoding: %d of %d"
          % (tag, rounds, verifies, drafted, accepted,
             accepted / max(drafted, 1), steps, dl, dpre, dsteps, same,
             len(prompts)))
    check(verifies > 0 and drafted == SPEC_K * verifies,
          "%d verifies, %d drafted" % (verifies, drafted))
    check(accepted > 0 or not accepting, "%s: no draft accepted, so no "
          "verify row past the first decided a token" % tag)
    check(dpre == len(prompts) and dsteps >= (SPEC_K + 1) * rounds,
          "draft admissions %d, steps %d" % (dpre, dsteps))
    check(launches["flash_attention"] == dl * dpre > 0,
          "B2 launches %d != %d x %d draft admissions"
          % (launches["flash_attention"], dl, dpre))
    check(launches["decode_attention"] == dl * dsteps > 0,
          "B4 launches %d != %d x %d draft steps"
          % (launches["decode_attention"], dl, dsteps))
    check(launches["decode_attention_paged"] ==
          FULL["num_layers"] * (steps + verifies),
          "B5 launches %d != %d x (%d plain steps + %d verifies)"
          % (launches["decode_attention_paged"], FULL["num_layers"], steps,
             verifies))
    per_draft = len(lm_mul_weight_names(dl))
    want_b3 = (INT8_PER_PASS * (len(prompts) + steps + verifies)
               + per_draft * (dpre + dsteps)) if int8 else 0
    check(launches["int8_matmul"] == want_b3,
          "int8 launches %d != %d" % (launches["int8_matmul"], want_b3))
    if int8:
        ours = spec.model.reference_state()
        for name in lm_mul_weight_names(dl):
            w, scale = d.model.mul_weight(name)
            check(w.dtype == torch.int8 and scale is not None
                  and w.data_ptr() == ours[name].data_ptr(),
                  "the draft's %s is not the target's int8 tensor" % name)
        print("[%s] B3: %d launches = %d x (%d admissions + %d plain steps "
              "+ %d verifies) + %d x (%d draft admissions + %d draft "
              "steps); the draft's %d armed weights are the target's int8 "
              "tensors" % (tag, launches["int8_matmul"], INT8_PER_PASS,
                           len(prompts), steps, verifies, per_draft, dpre,
                           dsteps, per_draft))
    return launches


def phase_constrain_serve(greedy, sampled, dead, prompts):
    """The number-list grammar over the full vocabulary, greedy and
    sampled: the paged cell's five requests, every emitted token legal in
    its state, every decode step through B5; then a grammar that dies
    after its first token: each request resolves with ConstraintDeadEnd,
    and the dispatcher serves on."""
    from paddle_tpu_torch.serving import GenerationScheduler
    from paddle_tpu_torch.serving.decoding import ConstraintDeadEnd
    c = greedy.policy.constraint
    for tag, sess, seeds in (("greedy", greedy, None),
                             ("sample", sampled, SAMPLE_SEEDS)):
        reset_launches()
        steps0 = sess.steps
        outs = serve_seeded(sess, prompts, seeds or [None] * len(prompts))
        launches = read_launches()
        steps = sess.steps - steps0
        visited = set()
        for out in outs:
            check(len(out) == NEW_TOKENS, "a constrained request returned "
                  "%d tokens" % len(out))
            state = c.start
            for t in out:
                try:
                    state = c.advance(state, int(t))
                except ValueError as exc:
                    raise SmokeFailure("constrain-serve %s: %s"
                                       % (tag, exc)) from None
                visited.add(state)
        print("[constrain-serve] %s: %d requests of %d tokens, every token "
              "legal; %d of the grammar's %d states visited; %d decode "
              "steps, B5 launches %d; first tokens %s"
              % (tag, len(outs), NEW_TOKENS, len(visited), c.num_states,
                 steps, launches["decode_attention_paged"],
                 [o[:8].tolist() for o in outs[:2]]))
        check(launches["decode_attention_paged"] ==
              FULL["num_layers"] * steps > 0, "B5 launches %s"
              % launches["decode_attention_paged"])
        sess.check_pool_invariant()
    sched = GenerationScheduler(dead)
    futs = [sched.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts[:2]]
    errors = []
    for f in futs:
        try:
            f.result(timeout=120)
        except ConstraintDeadEnd as exc:
            errors.append((exc.state, exc.position))
    # the dispatcher lives on: one more request after the dead ends
    try:
        sched.submit(prompts[2], max_new_tokens=NEW_TOKENS).result(
            timeout=120)
    except ConstraintDeadEnd as exc:
        errors.append((exc.state, exc.position))
    sched.drain(timeout=60)
    print("[constrain-serve] dead grammar: %d requests resolved with "
          "ConstraintDeadEnd (state, position) %s; dispatcher stopped: %s; "
          "slots active after: %d"
          % (len(errors), errors, sched._thread is None,
             int(dead.active.sum())))
    check(len(errors) == 3 and sched._thread is None
          and not dead.active.any(), "dead ends: %s" % errors)
    dead.check_pool_invariant()


class StepFault:
    """A ``generation_step_fail`` callback: raises on its ``at``-th call
    (session 0's ``at``-th decode step: mid-decode) and records when;
    every other call returns. With ``sleep`` it sleeps that long instead
    (a ``generation_session_wedge`` callback)."""

    def __init__(self, at, sleep=None):
        self.at, self.sleep = at, sleep
        self.calls = 0
        self.fired_at = None

    def __call__(self):
        self.calls += 1
        if self.calls != self.at:
            return
        self.fired_at = time.perf_counter()
        if self.sleep is not None:
            time.sleep(self.sleep)
            return
        from paddle_tpu_torch.resilience.faults import InjectedFault
        raise InjectedFault("injected step failure at session 0, step %d"
                            % self.at)


def failover_pair(base, paged_kw, policy=None, arm=False, **kw):
    """Two paged sessions of the flagship LM over ``base``'s weights by
    reference (``share=True``: one set of weights; arm=True takes the
    armed int8 tensors as they are)."""
    from paddle_tpu_torch.models.transformer import transformer_lm_session
    from paddle_tpu_torch.serving import GenerationSession
    return [GenerationSession(
        transformer_lm_session(decode_policy=policy, **dict(paged_kw, **kw)),
        base.model.reference_state(), arm_quant=arm, share=True)
        for _ in range(2)]


def registry_value(name, **labels):
    from paddle_tpu_torch.observability import metrics
    return sum(s["value"] for s in metrics.REGISTRY.dump().get(
        name, {}).get("samples", ()) if all(
            s["labels"].get(k) == v for k, v in labels.items()))


def chaos_serve(pair, prompts, base, tag, seeds=None, gap_sess=None,
                wedge=False, keep=False, at=FAIL_AT_STEP):
    """The five requests through a scheduler over ``pair``
    (FAILOVER_FLAGS; with ``wedge`` a step timeout too), all admitted
    into session 0, whose ``at``-th decode step fails (or, with
    ``wedge``, sleeps WEDGE_SLEEP_S past the timeout). Every stream must
    equal ``base`` (or, given ``gap_sess``, differ only at a near-tie),
    the failover and replayed-token counters rise, session 0's breaker
    opens. Returns (scheduler, seconds from the fault until every
    affected request resolved); the scheduler keeps serving with
    ``keep``."""
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.serving import GenerationScheduler
    kw = dict(FAILOVER_FLAGS)
    if wedge:
        kw["step_timeout_ms"] = WEDGE_TIMEOUT_MS
    sched = GenerationScheduler(pair, autostart=False, **kw)
    f0 = registry_value("paddle_generation_failover_total")
    r0 = registry_value("paddle_generation_replayed_tokens_total")
    t0 = registry_value("paddle_generation_step_timeouts_total")
    fault = StepFault(at, WEDGE_SLEEP_S if wedge else None)
    faults.arm("generation_session_wedge" if wedge else
               "generation_step_fail", at=0, times=None,
               action="callback", callback=fault)
    resolved = []
    try:
        futs = [sched.submit(p, max_new_tokens=NEW_TOKENS, eos_id=-1,
                             seed=None if seeds is None else seeds[i])
                for i, p in enumerate(prompts)]
        for f in futs:
            f.add_done_callback(lambda _f: resolved.append(
                time.perf_counter()))
        sched.start()
        outs = [f.result(timeout=600) for f in futs]
    finally:
        faults.disarm()
    recover_s = max(resolved) - fault.fired_at
    failovers = registry_value("paddle_generation_failover_total") - f0
    replayed = registry_value("paddle_generation_replayed_tokens_total") - r0
    timeouts = registry_value("paddle_generation_step_timeouts_total") - t0
    if gap_sess is None:
        same = sum(bool(np.array_equal(a, b)) for a, b in zip(outs, base))
    else:
        same = near_tie_rule("failover " + tag, base, outs, prompts,
                             gap_sess)
    print("[failover] %s: %s at session 0's decode step %d; %d of %d "
          "streams equal the fault-free run; failovers +%d, replayed "
          "tokens +%d, step timeouts +%d; session health %s; fault -> "
          "every affected request resolved %.3f s"
          % (tag, "a wedge of %.1f s past a %.0f ms step timeout"
             % (WEDGE_SLEEP_S, WEDGE_TIMEOUT_MS) if wedge else "a failure",
             at, same, len(prompts), failovers, replayed,
             timeouts, sched.session_health(), recover_s))
    check(fault.fired_at is not None, "%s: the fault never fired" % tag)
    check(gap_sess is not None or same == len(prompts),
          "%s: %d of %d replayed streams equal the fault-free run"
          % (tag, same, len(prompts)))
    check(failovers >= len(prompts) and replayed > 0,
          "%s: failovers +%d, replayed tokens +%d"
          % (tag, failovers, replayed))
    check(not wedge or timeouts == 1, "%s: step timeouts +%d"
          % (tag, timeouts))
    check(sched.session_health()[0] == "open" or sched._rebuilding or
          sched.sessions[0] is not pair[0],
          "%s: session 0 is not quarantined" % tag)
    if not keep:
        sched.drain(timeout=120)
    return sched, recover_s


def await_rebuild(sched, old, timeout=180.0):
    """Wait until session 0 of ``sched`` is no longer ``old``: the
    rebuild built, warmed and was swapped in. Returns the seconds it
    took."""
    t0 = time.perf_counter()
    while sched.sessions[0] is old or sched._rebuilding:
        check(time.perf_counter() - t0 < timeout,
              "session 0 was not rebuilt within %.0f s" % timeout)
        time.sleep(0.005)
    return time.perf_counter() - t0


def serve_rebuilt(sched, prompt, want, tag):
    """One more request after a rebuild: admitted into the rebuilt
    session 0 and equal to plain decoding."""
    new = sched.sessions[0]
    before = new.prefills
    out = sched.submit(prompt, max_new_tokens=NEW_TOKENS,
                       eos_id=-1).result(timeout=600)
    print("[failover] %s: session 0 rebuilt (breaker %s, %d warm-up "
          "admissions), served one more request: equal to plain decoding "
          "%s" % (tag, sched.session_health()[0], before,
                  bool(np.array_equal(out, want))))
    check(new.prefills == before + 1, "%s: the request did not land on "
          "the rebuilt session" % tag)
    check(np.array_equal(out, want), "%s: the rebuilt session's stream "
          "differs from plain decoding" % tag)


def token_ms(pair, prompts, route):
    """One fault-free round of SLOTS requests of NEW_TOKENS through a
    scheduler over ``pair`` (all admitted into session 0 at once, so
    every decode step has SLOTS active), its steps by ``route``:
    "inline" (step timeouts off), "worker" (on, at WEDGE_TIMEOUT_MS: the
    port's one long-lived step thread a session) or "fresh" (on, each
    step on a thread of its own through ``resilience.run_bounded``, the
    reference's route, patched in here to measure it). Returns the mean
    decode step's ms per emitted token (the scheduler's own step clock,
    ``paddle_request_decode_step_ms``: phase 1, the device step and its
    hand-off to a thread when timed)."""
    from paddle_tpu_torch.observability import request_trace
    from paddle_tpu_torch.serving import GenerationScheduler
    from paddle_tpu_torch.serving import resilience
    sched = GenerationScheduler(
        pair, autostart=False,
        step_timeout_ms=0 if route == "inline" else WEDGE_TIMEOUT_MS)
    if route == "fresh":
        sched._step_timed = lambda si, sess, prepared: \
            resilience.run_bounded(
                lambda: sched._step_session(si, sess, prepared),
                sched.step_timeout, name="generation-step-%d" % si)
    h = request_trace.DECODE_STEP_MS._default()
    n0, s0 = h.count, h.sum
    futs = [sched.submit(p, max_new_tokens=NEW_TOKENS, eos_id=-1)
            for p in prompts]
    sched.start()
    for f in futs:
        check(len(f.result(timeout=600)) == NEW_TOKENS, "a timing request "
              "was cut short")
    sched.drain(timeout=60)
    return (h.sum - s0) / (h.count - n0) / SLOTS


def phase_failover(paged, quant, prompts, paged_outs, sample_outs,
                   quant_outs, paged_kw, smi):
    """Scheduler resilience at full width, on sessions over the f32
    paged and the int8/bf16 cells' weights by reference, with replay
    (FAILOVER_FLAGS): a step failure mid-decode on session 0 replays the
    five requests on session 1 equal to the fault-free run, greedy,
    sampled (SAMPLE_SEEDS) and int8/bf16 greedy; session 0 is rebuilt and
    serves one more request; a wedge past the step timeout quarantines
    and rebuilds session 0, its requests replayed equal; a speculative
    pair (the whole target as the draft) keeps its greedy streams equal
    to plain decoding through a step failure; the time per emitted token
    at SLOTS active with step timeouts off and on; a swap to another
    weight set (seed 1) on an idle scheduler serves what a fresh session
    on those weights serves, and the swap back, made mid-decode, with
    its wall time and the longest gap between two decode steps around
    it. Returns the phase's launch counts."""
    import torch
    from paddle_tpu_torch.models.transformer import transformer_lm_session
    from paddle_tpu_torch.serving import GenerationSession
    from paddle_tpu_torch.serving.decoding import DecodePolicy
    card = smi[0] if smi else "nvidia-smi: no output"
    reset_launches()
    pair = failover_pair(paged, paged_kw)
    sched, greedy_s = chaos_serve(pair, prompts, paged_outs, "f32 greedy",
                                  keep=True)
    # session 0's breaker is open, its cooldown a minute: the rebuild a
    # wedge would start, started now
    t0 = time.perf_counter()
    sched._maybe_rebuild(0, force=True)
    await_rebuild(sched, pair[0])
    rebuild_s = time.perf_counter() - t0
    serve_rebuilt(sched, prompts[0], paged_outs[0], "f32 greedy")
    sched.drain(timeout=120)
    pair = list(sched.sessions)
    for sess in pair:
        sess.check_pool_invariant()
    sampled = failover_pair(paged, paged_kw, DecodePolicy(
        "sample", **SAMPLE_KNOBS))
    _, sample_s = chaos_serve(sampled, prompts, sample_outs, "f32 sampled",
                              seeds=SAMPLE_SEEDS)
    for sess in sampled:
        sess.close()
    armed = failover_pair(quant, paged_kw, arm=True, dtype="bfloat16")
    _, int8_s = chaos_serve(armed, prompts, quant_outs, "int8/bf16 greedy")
    for sess in armed:
        sess.close()
    spec = failover_pair(paged, paged_kw, DecodePolicy(
        speculate_k=SPEC_K, draft=dict(num_layers=FULL["num_layers"])))
    # a round of the whole-target draft emits up to SPEC_K + 1 tokens:
    # its third round is mid-decode
    _, spec_s = chaos_serve(spec, prompts, paged_outs,
                            "speculative (whole-target draft) greedy",
                            gap_sess=paged, at=3)
    for sess in spec:
        sess.close()
    sched, wedge_s = chaos_serve(pair, prompts, paged_outs, "f32 greedy",
                                 wedge=True, keep=True)
    await_rebuild(sched, pair[0])
    serve_rebuilt(sched, prompts[0], paged_outs[0], "wedge")
    sched.drain(timeout=120)
    pair = list(sched.sessions)
    # the time per emitted token with step timeouts off and on, in turns
    extra = [np.concatenate([prompts[4], prompts[i][:8]]) for i in range(3)]
    eight = list(prompts) + extra
    per_token = {"inline": [], "worker": [], "fresh": []}
    for _ in range(TIMING_ROUNDS):
        for route in per_token:
            per_token[route].append(token_ms(pair, eight, route))
    med = {k: sorted(v)[len(v) // 2] for k, v in per_token.items()}
    # a swap to another weight set (seed 1) on an idle scheduler
    from paddle_tpu_torch.serving import GenerationScheduler
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    old_state = paged.model.reference_state()
    new_weights = {n: (t.clone() if t.dim() == 1 else torch.randn(
        t.shape, generator=gen, device="cuda") * 0.02)
        for n, t in old_state.items()}
    fresh = GenerationSession(transformer_lm_session(**paged_kw),
                              new_weights)
    fresh_outs = serve_seeded(fresh, prompts, [None] * len(prompts))
    fresh.close()
    del fresh
    # no dispatcher yet: the swap installs on this thread, and the five
    # requests are admitted in order as the fresh session's were (the
    # same prefix sharing)
    sched = GenerationScheduler(pair, autostart=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    version = sched.swap_weights(new_weights)
    torch.cuda.synchronize()
    swap_idle_s = time.perf_counter() - t0
    del new_weights
    futs = [sched.submit(p, max_new_tokens=NEW_TOKENS, eos_id=-1)
            for p in prompts]
    sched.start()
    outs = [f.result(timeout=600) for f in futs]
    swapped_same = sum(bool(np.array_equal(a, b))
                       for a, b in zip(outs, fresh_outs))
    differs = sum(not np.array_equal(a, b) for a, b in zip(outs, paged_outs))
    # the swap back, made while the five requests decode: its wall time
    # and the longest gap between two decode steps around it
    stamps = []
    futs = [sched.submit(p, max_new_tokens=NEW_TOKENS, eos_id=-1,
                         on_token=(lambda t: stamps.append(
                             time.perf_counter())) if i == 0 else None)
            for i, p in enumerate(prompts)]
    while len(stamps) < NEW_TOKENS // 4:
        time.sleep(0.001)
    t0 = time.perf_counter()
    version_back = sched.swap_weights(old_state)
    swap_busy_s = time.perf_counter() - t0
    mid = [f.result(timeout=600) for f in futs]
    gaps = np.diff(stamps) * 1e3
    back = sched.submit(prompts[0], max_new_tokens=NEW_TOKENS,
                        eos_id=-1).result(timeout=600)
    sched.drain(timeout=120)
    torch.cuda.synchronize()
    launches = read_launches()
    for sess in pair:
        sess.check_pool_invariant()
        sess.close()
    print("[failover] swap to seed-1 weights on an idle scheduler: version "
          "%d in %.3f s; %d of %d streams equal a fresh session on those "
          "weights (%d differ from the seed-%d streams); swapped back "
          "mid-decode (version %d) in %.3f s, the longest gap between two "
          "decode steps around it %.3f ms (median gap %.3f ms), %d "
          "requests of %d tokens; after it request 0 equals the first "
          "weights' stream: %s"
          % (version, swap_idle_s, swapped_same, len(prompts), differs, 0,
             version_back, swap_busy_s, gaps.max(), float(np.median(gaps)),
             len(mid), NEW_TOKENS, bool(np.array_equal(back,
                                                        paged_outs[0]))))
    print("[failover] timings (%s): time per emitted token at %d active "
          "slots, step timeouts off %.4f ms, at %.0f ms %.4f ms on the "
          "session's step thread, %.4f ms on a fresh thread a step (the "
          "reference's route; median of %d rounds in turns; all %s); fault "
          "-> every affected request "
          "resolved: f32 greedy %.3f s, f32 sampled %.3f s, int8/bf16 "
          "%.3f s, speculative %.3f s, wedge %.3f s (timeout %.0f ms, "
          "sleep %.1f s); rebuild (construct, warm buckets %s and a decode "
          "step, hand-over) %.3f s; swap of the f32 weights %.3f s idle, "
          "%.3f s mid-decode; launches %s"
          % (card, SLOTS, med["inline"], WEDGE_TIMEOUT_MS, med["worker"],
             med["fresh"], TIMING_ROUNDS, {k: [round(x, 4) for x in v]
                             for k, v in per_token.items()},
             greedy_s, sample_s, int8_s, spec_s, wedge_s, WEDGE_TIMEOUT_MS,
             WEDGE_SLEEP_S, BUCKETS, rebuild_s, swap_idle_s, swap_busy_s,
             launches))
    check(version == 1 and version_back == 2, "weights versions %d, %d"
          % (version, version_back))
    check(swapped_same == len(prompts), "%d of %d streams on the swapped "
          "weights equal a fresh session's" % (swapped_same, len(prompts)))
    check(differs == len(prompts), "the swapped weights served the first "
          "weights' streams")
    check(all(len(o) == NEW_TOKENS and ((o >= 0) & (o < FULL["vocab_size"]))
              .all() for o in mid), "a request across the swap back failed")
    check(np.array_equal(back, paged_outs[0]), "after the swap back the "
          "stream differs from the first weights'")
    for name in ("decode_attention_paged", "int8_matmul", "flash_attention",
                 "decode_attention"):
        check(launches[name] > 0, "[failover] launched no %s" % name)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_policy_latency(dense, paged, pol, rng):
    """Host clock, in turns: the decode step with 8 active slots, greedy
    and sampled, dense and paged (16 steps a round, median of
    LATENCY_ROUNDS), and the sampling alone (the keys derived on the
    host and sent, then ``policy_epilogue`` on the step's [8, V] logits,
    ended by its tokens read back); then, with 8
    active slots and with 1, the time per emitted token over rounds of 4
    steps of the plain paged session and of the speculative ones (greedy,
    the 1-layer self-draft and the whole target as the draft), with their
    accept rates."""
    import torch
    from paddle_tpu_torch.models.transformer import policy_epilogue
    from paddle_tpu_torch.ops.random_ops import decoding_key
    v = FULL["vocab_size"]
    stepped = (("dense", dense), ("dense sampled", pol["sample dense"]),
               ("paged", paged), ("paged sampled", pol["sample"]))
    for i, (_, sess) in enumerate(stepped):
        for j in range(SLOTS):
            sess.admit(rng.integers(2, v, 64 + 56 * j), seed=100 + j)
        for _ in range(3):
            sess.step()
    logits = torch.from_numpy(rng.standard_normal(
        (SLOTS, v), dtype=np.float32)).cuda()
    seeds = torch.arange(SLOTS)
    steps = torch.full((SLOTS,), 300)
    runs = {name: [] for name, _ in stepped}
    runs["sampling alone"] = []
    for _ in range(LATENCY_ROUNDS):
        for name, sess in stepped:
            t0 = time.perf_counter()
            for _ in range(16):
                sess.step()
            runs[name].append((time.perf_counter() - t0) * 1e3 / 16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(16):
            # the keys derived on the host and sent, as a session does
            keys = decoding_key(seeds, steps).cuda()
            policy_epilogue(logits, pol["sample"].policy, keys).cpu()
        runs["sampling alone"].append((time.perf_counter() - t0) * 1e3 / 16)
    for _, sess in stepped:
        for s in range(SLOTS):
            sess.retire(s)
    # speculative rounds against plain steps, in turns, at 8 active slots
    # and at 1 (the low-batch regime speculation is for): ms per emitted
    # token over 4 steps a round, and the accept rates
    per_token, rates = {}, {}
    specs = (("paged", paged), ("spec", pol["spec"]),
             ("spec full draft", pol["spec full draft"]))
    for active in (SLOTS, 1):
        for _, sess in specs:
            for j in range(active):
                sess.admit(rng.integers(2, v, 64 + 56 * j))
            for _ in range(2):
                sess.step()
        for name, _ in specs:
            per_token[name, active], rates[name, active] = [], []
        for _ in range(LATENCY_ROUNDS):
            for name, sess in specs:
                d0, a0 = sess.spec_drafted, sess.spec_accepted
                emitted = 0
                t0 = time.perf_counter()
                for _ in range(4):
                    emitted += sum(len(t) if isinstance(t, list) else 1
                                   for t in sess.step().values())
                per_token[name, active].append(
                    (time.perf_counter() - t0) * 1e3 / emitted)
                if sess.speculative:
                    rates[name, active].append(
                        (sess.spec_accepted - a0) / (sess.spec_drafted - d0))
        for _, sess in specs:
            for s in range(active):
                sess.retire(s)
    med = {k: sorted(t)[len(t) // 2] for k, t in runs.items()}
    tok = {k: sorted(t)[len(t) // 2] for k, t in per_token.items()}
    print("[latency] decode step with %d active slots ms (median of %d "
          "rounds of 16, in turns): dense greedy %.3f, dense sampled %.3f "
          "(+%.3f), paged greedy %.3f, paged sampled %.3f (+%.3f); the "
          "sampling alone (%s at [%d, %d], tokens read back) %.3f ms; all "
          "runs %s"
          % (SLOTS, LATENCY_ROUNDS, med["dense"], med["dense sampled"],
             med["dense sampled"] - med["dense"], med["paged"],
             med["paged sampled"], med["paged sampled"] - med["paged"],
             pol["sample"].policy.fingerprint(), SLOTS, v,
             med["sampling alone"],
             {k: [round(x, 3) for x in t] for k, t in runs.items()}))
    for active in (SLOTS, 1):
        print("[latency] %d active slot(s), ms per emitted token (median of "
              "%d rounds of 4 steps, in turns): plain paged greedy %.3f; "
              "speculative greedy (k %d), 1-layer self-draft %.3f (accept "
              "rates %s), %d-layer draft (the whole target) %.3f (accept "
              "rates %s); all runs %s"
              % (active, LATENCY_ROUNDS, tok["paged", active], SPEC_K,
                 tok["spec", active],
                 [round(r, 4) for r in rates["spec", active]],
                 FULL["num_layers"], tok["spec full draft", active],
                 [round(r, 4) for r in rates["spec full draft", active]],
                 {k[0]: [round(x, 3) for x in t]
                  for k, t in per_token.items() if k[1] == active}))


def phase_profile_sampling(sess, rng):
    """torch.profiler over 4 sampled paged decode steps with every slot
    active, then over 4 calls of the sampling alone on [8, V] logits: the
    sampling's share of a sampled step's device time and wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.models.transformer import policy_epilogue
    from paddle_tpu_torch.ops.random_ops import decoding_key
    v = FULL["vocab_size"]
    for j in range(SLOTS):
        sess.admit(rng.integers(2, v, 64 + 56 * j), seed=j)
    sess.step()
    logits = torch.from_numpy(rng.standard_normal(
        (SLOTS, v), dtype=np.float32)).cuda()
    seeds = torch.arange(SLOTS)
    steps = torch.full((SLOTS,), 300)
    out = {}
    for label, fn in (
            ("4 sampled paged decode steps",
             lambda: [sess.step() for _ in range(4)]),
            ("4 calls of the sampling alone",
             lambda: [policy_epilogue(logits, sess.policy, decoding_key(
                 seeds, steps).cuda()).cpu() for _ in range(4)])):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy, launches = 0.0, 0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                busy += e.time_range.elapsed_us() / 1e3
                launches += 1
        out[label] = (wall, busy, launches)
        print("[profile] %s: wall %.3f ms, device busy %.3f ms, %d device "
              "events" % (label, wall, busy, launches))
    for s in range(SLOTS):
        sess.retire(s)
    (sw, sb, _), (aw, ab, _) = out.values()
    if sb:
        print("[profile] the sampling's share of a sampled paged step: "
              "%.1f%% of its wall time, %.1f%% of its device time"
              % (100 * aw / sw, 100 * ab / sb))


def phase_latency(sess, rng):
    """End-to-end on one session, host clock around work that ends in a
    token read back: TTFT of an idle server per prompt bucket, and the
    decode step with every slot active."""
    import torch
    ttft = {}
    for p in BUCKETS:
        times = []
        for _ in range(3):
            prompt = rng.integers(2, FULL["vocab_size"], p)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            slot, _ = sess.admit(prompt)
            times.append((time.perf_counter() - t0) * 1e3)
            sess.retire(slot)
        ttft[p] = sorted(times)[1]
    for i in range(SLOTS):
        sess.admit(rng.integers(2, FULL["vocab_size"], 64 + 56 * i))
    for _ in range(3):
        sess.step()
    rounds = []
    for _ in range(3):
        n = 16
        t0 = time.perf_counter()
        for _ in range(n):
            sess.step()
        rounds.append((time.perf_counter() - t0) * 1e3 / n)
    for s in range(SLOTS):
        sess.retire(s)
    step_ms = sorted(rounds)[1]
    print("[latency] ttft_ms (idle server, median of 3) %s; decode step "
          "with %d active slots %.3f ms (%.3f ms per token; median of 3 "
          "rounds of 16 steps: %s)"
          % ({k: round(v, 3) for k, v in ttft.items()}, SLOTS, step_ms,
             step_ms / SLOTS, [round(r, 3) for r in rounds]))


def profile_window(label, fn, markers=()):
    """torch.profiler over ``fn()``: prints the window's wall time, its
    device-busy share (kernel time over wall time; one stream, so kernels
    do not overlap), the share and launches of each of ``markers``
    ((label, kernel-name fragments)) and the top kernels. Returns
    {marker label: launches, "busy_share": the busy share}, or None when
    the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return profile_summary(prof, label, wall_us, markers)


def profile_summary(prof, label, wall_us, markers=()):
    """``profile_window``'s report of a finished profiler session over a
    window of ``wall_us`` microseconds."""
    import torch
    by_name, count = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
            count[e.name] = count.get(e.name, 0) + 1
    busy = sum(by_name.values())
    if not busy:
        print("[profile] %s: the profiler saw no device time (not "
              "measured)" % label)
        return None
    print("[profile] %s: wall %.3f ms, device busy %.3f ms (%.1f%%)"
          % (label, wall_us / 1e3, busy / 1e3, 100 * busy / wall_us))
    launched = {"busy_share": busy / wall_us}
    for kernel, names in markers:
        mine = sum(us for n, us in by_name.items()
                   if any(m in n for m in names))
        launched[kernel] = sum(k for n, k in count.items()
                               if any(m in n for m in names))
        print("[profile]   %s %.3f ms, %.1f%% of busy, %d launches"
              % (kernel, mine / 1e3, 100 * mine / busy,
                 launched[kernel]))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    for name, us in top:
        print("[profile]   %6.1f%% %9.3f ms  %s"
              % (100 * us / busy, us / 1e3, name[:110]))
    return launched


def phase_profile(sess, rng, paged, system, quant):
    """Where device time goes: torch.profiler over one 512-token
    admission, then over 4 decode steps with every slot active; on the
    ``paged`` session and on the int8/bf16 ``quant`` session, the same
    over one prefix-hit admission (window 108 after the cached
    ``system`` prompt) and 4 paged decode steps.
    Prints each window's device-busy share (kernel time over wall time;
    one stream, so kernels do not overlap), its top kernels and the
    shares of the busy time of B4 (dense decode), B5 (paged decode) and,
    on the int8 session, B3."""
    b3 = ("B3 (quantize pass, split-K decode kernel, prefill GEMM)",
          ("quantize_rows_kernel", "int8_gemv_kernel", "int8_gemm_kernel"))
    b4 = ("B4 (dense_decode_kernel)", ("dense_decode_kernel",))
    b5 = ("B5 (split and combine)", ("paged_split_kernel",
                                     "paged_combine_kernel"))
    prompt = rng.integers(2, FULL["vocab_size"], BUCKETS[-1])
    profile_window("prefill 512",
                   lambda: sess.retire(sess.admit(prompt)[0]))
    for i in range(SLOTS):
        sess.admit(rng.integers(2, FULL["vocab_size"], 64 + 56 * i))
    launched = profile_window("4 decode steps, %d slots" % SLOTS,
                              lambda: [sess.step() for _ in range(4)],
                              (b4,))
    # B4 makes one launch a call: one a layer and step
    check(launched is None or launched[b4[0]] == 4 * FULL["num_layers"],
          "the dense decode window launched %s B4 kernels, not one a layer "
          "and step" % (launched or {}).get(b4[0]))
    for s in range(SLOTS):
        sess.retire(s)
    for label, ps, markers in (("paged", paged, (b5,)),
                               ("int8/bf16 paged", quant, (b3, b5))):
        hit = np.concatenate([system,
                              rng.integers(2, FULL["vocab_size"], 108)])
        profile_window("%s prefill, 192-token prefix hit, window 108"
                       % label, lambda: ps.retire(ps.admit(hit)[0]),
                       markers)
        for i in range(SLOTS):
            ps.admit(rng.integers(2, FULL["vocab_size"], 64 + 56 * i))
        profile_window("4 %s decode steps, %d slots" % (label, SLOTS),
                       lambda: [ps.step() for _ in range(4)], markers)
        for s in range(SLOTS):
            ps.retire(s)


def phase_time(rng, launches, errs, final_lengths, paged_final,
               quant_launches, b4_bf16_launches, program_rng):
    """Each kernel at the path's shapes: its time, its plain version's,
    the library call's, and its bound from this run's inputs. The decode
    kernels on float32 and bfloat16 caches; the int8 kernel at each
    (m, k, n) of the serving path, and at PROGRAM_INT8_SHAPES from
    ``program_rng``."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.probes.common import cuda_ms
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.probes.decode import split_work
    h, d = FULL["num_heads"], FULL["d_model"] // FULL["num_heads"]
    rows = []

    # prefill attention at both buckets, each with a prompt filling it:
    # the kernel, its plain version and SDPA between CUDA events over
    # queued calls (the profiler's kernel sum beside the kernel's)
    for p in BUCKETS:
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (1, h, p, d), dtype=np.float32)).cuda() for _ in range(3))
        seg = torch.ones(1, p, dtype=torch.int32, device="cuda")
        kernel = functools.partial(fa.flash_attention, q, k, v, True, seg)
        ms, profiler_ms = two_clocks(kernel, iters=30)
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, True,
                                                            seg))
        live = torch.ones(p, p, dtype=torch.bool, device="cuda").tril()
        live &= (seg[0][:, None] == seg[0][None, :]) & (seg[0][None, :] != 0)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=live[None, None]))
        pairs = p * (p + 1) // 2            # attendable (query, key) pairs
        flops = 4 * d * h * pairs           # QK^T and PV, 2 flops per MAC
        nbytes = 4 * (4 * h * p * d) + 4 * p
        bound, bound_by = roofline_ms(nbytes, flops)
        rows.append(dict(
            name="flash_attention", route="cuda",
            source="paddle_tpu_torch/csrc/flash_attention.cu",
            replaces="paddle_tpu/ops/pallas_attention.py:584",
            launches=launches["flash_attention"],
            max_abs_err=errs["flash_attention"], ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=bound_by, library_ms=lib_ms,
            dtype="float32", shape=[1, h, p, d], profiler_ms=profiler_ms))
    notes = ["flash_attention float32: launches are the dense cell's, both "
             "buckets"]

    # decode attention: all slots, the lengths the served requests ended
    # at, free slots at length 1 (as the path runs them); float32 caches
    # (the dense cell) and bfloat16 (the int8/bf16 small LM)
    s, c = SLOTS, CACHE_LEN
    lens_dense = np.ones(s, np.int32)
    lens_dense[:len(final_lengths)] = final_lengths
    q = torch.from_numpy(rng.standard_normal((s, h * d), dtype=np.float32))
    kc32, vc32 = (torch.from_numpy(rng.standard_normal(
        (s, c, h * d), dtype=np.float32)) for _ in range(2))
    q, kc32, vc32 = q.cuda(), kc32.cuda(), vc32.cuda()
    lens = torch.from_numpy(lens_dense).cuda()
    qt = q.reshape(s, h, 1, d)
    mask = (torch.arange(c, device="cuda")[None] < lens[:, None])
    total = int(lens_dense.sum())
    for dt, count, err in ((torch.float32, launches["decode_attention"],
                            errs["decode_attention"]),
                           (torch.bfloat16, b4_bf16_launches,
                            errs["decode_attention bf16"])):
        kc, vc = kc32.to(dt), vc32.to(dt)
        kernel = functools.partial(fa.decode_attention, q, kc, vc, lens, h)
        warm_ms, profiler_ms = two_clocks(kernel, iters=30)
        live = 2 * total * h * d * kc.element_size()
        ms = cold_ms(lambda: functools.partial(
            fa.decode_attention, q, kc.clone(), vc.clone(), lens, h), live)
        plain_ms = cuda_ms(lambda: fa.decode_attention_plain(
            q, kc, vc, lens, h))

        def sdpa():
            kt = kc.reshape(s, c, h, d).transpose(1, 2).contiguous()
            vt = vc.reshape(s, c, h, d).transpose(1, 2).contiguous()
            return lambda: F.scaled_dot_product_attention(
                qt.to(dt), kt, vt, attn_mask=mask[:, None, None, :])

        sdpa_ms = cold_ms(sdpa, live)
        nbytes = live + 2 * s * h * d * 4 + 4 * s
        bound, bound_by = roofline_ms(nbytes, 4 * total * h * d)
        bf16 = dt == torch.bfloat16
        # the CTAs that took a work item, counted on the card by one more
        # launch (not a path launch) at the dense cell's final lengths
        plan = fa._split_plan(s, h, d, c)
        fn = _build.entry("decode_attention_" + ("bf16" if bf16 else "f32"))
        working, items = split_work(lambda work: fa._launch_dense(
            q, kc, vc, lens, h, plan, fn, work))
        want_items = h * sum(-(-int(n) // plan.chunk) for n in lens_dense)
        check(items == want_items and 0 < working <= plan.ctas,
              "decode_attention took %d work items in %d CTAs; the lengths "
              "give %d items, the grid %d CTAs"
              % (items, working, want_items, plan.ctas))
        rows.append(dict(
            name="decode_attention", route="cuda",
            source="paddle_tpu_torch/csrc/decode_attention.cu",
            replaces="paddle_tpu/ops/pallas_attention.py:558",
            launches=count, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=bound_by,
            # no one PyTorch call takes f32 queries over bf16 caches;
            # SDPA over all-bf16 inputs is printed as a yardstick
            library_ms=None if bf16 else sdpa_ms,
            kv_dtype="bfloat16" if bf16 else "float32",
            warm_ms=warm_ms, profiler_ms=profiler_ms, chunk=plan.chunk,
            ctas=plan.ctas, ctas_with_work=working))
        notes.append("decode_attention %s split: chunks of %d rows, %d CTAs "
                     "launched, %d took work (%d work items of one head, "
                     "counted on the card), one launch a call"
                     % (str(dt)[6:], plan.chunk, plan.ctas, working, items))
        if bf16:
            rows[-1]["launches_in"] = "[small-lm] dense int8/bf16"
            notes.append("decode_attention bf16: no single PyTorch call "
                         "takes f32 queries over bf16 caches; SDPA with "
                         "the queries cast to bf16 %.4f ms" % sdpa_ms)

    # paged decode attention: the paged cell's pool and tables, the
    # lengths its requests ended at, free slots at length 1 with all-dead
    # table rows (as the path runs them); float32 pools (the paged cell)
    # and bfloat16 (the int8/bf16 session, which served the same traffic)
    mb = -(-CACHE_LEN // BLOCK_SIZE)
    nb = SLOTS * mb
    plens = [0] * s
    plens[:len(paged_final)] = paged_final
    q, pk32, pv32, lens, tables = paged_case(rng, plens, h, d, nb,
                                             BLOCK_SIZE, mb, poison=False)
    c = mb * BLOCK_SIZE
    mask = (torch.arange(c, device="cuda")[None] < lens[:, None])
    lens_host = lens.cpu().numpy()
    total = int(lens_host.sum())
    live_entries = int(sum(-(-n // BLOCK_SIZE) for n in lens_host))
    for dt, count, err in ((torch.float32, launches["decode_attention_paged"],
                            errs["decode_attention_paged"]),
                           (torch.bfloat16,
                            quant_launches["decode_attention_paged"],
                            errs["decode_attention_paged bf16"])):
        pk, pv = pk32.to(dt), pv32.to(dt)
        kernel = functools.partial(fa.decode_attention_paged, q, pk, pv,
                                   lens, tables, h)
        warm_ms, profiler_ms = two_clocks(kernel, iters=30)
        live = 2 * total * h * d * pk.element_size()
        ms = cold_ms(lambda: functools.partial(
            fa.decode_attention_paged, q, pk.clone(), pv.clone(), lens,
            tables, h), live)
        plain_ms = cuda_ms(lambda: fa._decode_paged_reference(
            q, pk, pv, lens, tables, h))

        def gather_sdpa():
            kp, vp = pk.clone(), pv.clone()

            def call():
                tbl = tables.long().clamp(0, nb - 1)
                kt = kp[tbl].reshape(s, c, h, d).transpose(1, 2)
                vt = vp[tbl].reshape(s, c, h, d).transpose(1, 2)
                return F.scaled_dot_product_attention(
                    q.reshape(s, h, 1, d).to(dt), kt, vt,
                    attn_mask=mask[:, None, None, :])
            return call

        gather_sdpa_ms = cold_ms(gather_sdpa, live)
        # the split's CTAs that took a work item, counted on the card by
        # one more launch (not a path launch) at the path's final lengths
        plan = fa._paged_plan(s, h, d, BLOCK_SIZE, mb)
        fn = _build.entry("decode_attention_paged_"
                          + ("bf16" if dt == torch.bfloat16 else "f32"))
        working, items = split_work(lambda work: fa._launch_paged(
            q, pk, pv, lens, tables, h, plan, fn, work))
        want_items = h * sum(-(-int(n) // plan.chunk) for n in lens_host)
        check(items == want_items and 0 < working <= plan.ctas,
              "decode_attention_paged's split took %d work items in %d "
              "CTAs; the lengths give %d items, the grid %d CTAs"
              % (items, working, want_items, plan.ctas))
        notes.append("decode_attention_paged %s split: chunks of %d rows, "
                     "%d CTAs launched, %d took work (%d work items of one "
                     "head, counted on the card), %d combine CTAs" % (
                         str(dt)[6:], plan.chunk, plan.ctas, working, items,
                         -(-s * h // 4)))
        nbytes = live + 2 * s * h * d * 4 + 4 * s + 4 * live_entries
        bound, bound_by = roofline_ms(nbytes, 4 * total * h * d)
        bf16 = dt == torch.bfloat16
        rows.append(dict(
            name="decode_attention_paged", route="cuda",
            source="paddle_tpu_torch/csrc/decode_attention_paged.cu",
            replaces="paddle_tpu/ops/pallas_attention.py:486",
            launches=count, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=bound_by, library_ms=None,
            kv_dtype="bfloat16" if bf16 else "float32",
            warm_ms=warm_ms, profiler_ms=profiler_ms, chunk=plan.chunk,
            ctas=plan.ctas, ctas_with_work=working))
        notes.append("decode_attention_paged %s: a gather of the pools plus "
                     "F.scaled_dot_product_attention (no single PyTorch call "
                     "computes it) %.4f ms on a cold L2"
                     % (rows[-1]["kv_dtype"], gather_sdpa_ms))

    for r in rows:
        lib = "none" if r["library_ms"] is None \
            else "%.4f ms" % r["library_ms"]
        label = r["name"] + (" " + r["kv_dtype"] if "kv_dtype" in r else "")
        if "shape" in r:
            label += " %s causal" % r["shape"]
        cold = "" if "warm_ms" not in r else \
            " on a cold L2 (warm %.4f ms)" % r["warm_ms"]
        print("[time] %s: %.4f ms between CUDA events over queued calls%s "
              "(profiler kernel sum %.4f ms; bound %.4f ms by %s), plain "
              "%.4f ms, library %s" % (label, r["ms"], cold,
                                       r["profiler_ms"], r["bound_ms"],
                                       r["bound_by"], r["plain_ms"], lib))
    # int8 weight compute at every (m, k, n) of the path: the kernel, its
    # plain version, the library route (quantize in torch, torch._int_mm
    # on m padded to what it takes, the epilogue) and the f32 product it
    # replaces, each by both clocks; at decode (m = SLOTS) the kernel and
    # the two routes also on a cold L2, as a decode step's 73 weights
    # find it
    from paddle_tpu_torch.ops import quant_ops
    int8_rows = []
    for (m, k, n), gen in [(shape, rng) for shape in INT8_SHAPES] + [
            (shape, program_rng) for shape in PROGRAM_INT8_SHAPES]:
        x = torch.from_numpy(gen.standard_normal((m, k), dtype=np.float32))
        x = x.cuda()
        wq, ws = quantized(gen, k, n)
        ms, profiler_ms = two_clocks(functools.partial(
            quant_ops.quant_matmul_2d, x, wq, ws))
        plain_ms, plain_profiler_ms = two_clocks(
            lambda: quant_ops.int8_matmul_plain(x, wq, ws))
        mp = max(24, -(-m // 8) * 8)     # _int_mm: m > 16, a multiple of 8

        def int_mm(wq=wq, ws=ws):
            xq, xs = quant_ops.quantize_rows(x)
            xq = F.pad(xq, (0, 0, 0, mp - m))
            return torch._int_mm(xq, wq)[:m].float() * xs * ws[None, :]

        def f32_matmul(w32):
            return lambda: torch.matmul(x, w32)

        decode = m <= quant_ops.DECODE_MAX_M
        cold = {}
        if decode:
            cold["kernel"] = cold_ms(lambda: functools.partial(
                quant_ops.quant_matmul_2d, x, wq.clone(), ws.clone()),
                k * n)
        try:
            lib_ms, lib_profiler_ms = two_clocks(int_mm)
            if decode:
                cold["library"] = cold_ms(lambda: functools.partial(
                    int_mm, wq.clone(), ws.clone()), k * n)
        except RuntimeError as exc:
            lib_ms = lib_profiler_ms = None
            notes.append("int8_matmul %s: torch._int_mm refused: %s"
                         % ((m, k, n), str(exc).splitlines()[0]))
        w32 = wq.float() * ws[None, :]
        f32_ms, f32_profiler_ms = two_clocks(f32_matmul(w32))
        if decode:
            cold["f32_matmul"] = cold_ms(lambda: f32_matmul(w32.clone()),
                                         4 * k * n)
        del w32
        nbytes = 4 * m * k + k * n + 4 * n + 4 * m * n
        bound, bound_by = roofline_ms(nbytes, 2 * m * k * n, INT8_OPS)
        plan = quant_ops._plan(m, k, n)
        rows.append(dict(
            name="int8_matmul", route="cuda",
            source="paddle_tpu_torch/csrc/int8_matmul.cu",
            replaces="paddle_tpu/ops/quant_ops.py:113",
            launches=quant_launches["int8_matmul"],
            max_abs_err=errs["int8_matmul"], ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=bound_by, library_ms=lib_ms,
            shape=[m, k, n], tile=[plan.bm, plan.bn],
            profiler_ms=profiler_ms, plain_profiler_ms=plain_profiler_ms,
            library_profiler_ms=lib_profiler_ms, f32_matmul_ms=f32_ms,
            f32_matmul_profiler_ms=f32_profiler_ms))
        if decode:
            # the kernels line's times are the cold ones, the warm beside
            r = rows[-1]
            for which, key in (("kernel", ""), ("library", "library_"),
                               ("f32_matmul", "f32_matmul_")):
                if which in cold:
                    r[key + "warm_ms"] = r[key + "ms"]
                    r[key + "ms"] = cold[which]
        int8_rows.append(rows[-1])
    print("[time] int8_matmul: each time between CUDA events over calls "
          "queued behind a sleep kernel (device time, every launch), the "
          "profiler's kernel sum beside it; at decode the first time is "
          "on a cold L2, the warm one beside it")
    for r in int8_rows:
        print("[time] int8_matmul m=%d k=%d n=%d (%s): %s; bound %.4f ms "
              "by %s" % (*r["shape"], "decode" if r["shape"][0] <=
                         quant_ops.DECODE_MAX_M else "tile %dx%d" %
                         tuple(r["tile"]), clocks(r, "kernel"),
                         r["bound_ms"], r["bound_by"]))
        print("[time]     plain %s; _int_mm route %s; f32 torch.matmul %s"
              % (clocks(r, "plain"), clocks(r, "library"),
                 clocks(r, "f32_matmul")))
    int8_passes(int8_rows)
    for note in notes:
        print("[time] " + note)
    print("[time] decode lengths: dense %s, paged %s"
          % (lens_dense.tolist(), lens_host.tolist()))
    return rows


def clocks(row, which):
    """A timing of ``row`` ("kernel", "plain", "library", "f32_matmul")
    by both clocks, as text."""
    key = {"kernel": "", "plain": "plain_", "library": "library_",
           "f32_matmul": "f32_matmul_"}[which]
    if row.get(key + "ms") is None:
        return "none"
    if row.get(key + "warm_ms") is not None:
        return "%.4f ms cold (warm %.4f, profiler %.4f)" % (
            row[key + "ms"], row[key + "warm_ms"], row[key + "profiler_ms"])
    return "%.4f ms (profiler %.4f)" % (row[key + "ms"],
                                        row[key + "profiler_ms"])


def int8_passes(int8_rows):
    """B3's device time summed over one pass of the int8 cell (a decode
    step's on a cold L2, its warm sum beside it): an
    admission whose window fills the 128 or the 512 bucket (each layer's
    q, k, v, o, ffn1 and ffn2 at m = bucket, the LM head at m = 1) and a
    decode step (the same at m = SLOTS, the head at m = SLOTS), by both
    clocks beside the bound and the two other routes (queued events)."""
    from paddle_tpu_torch.ops import quant_ops
    by_shape = {tuple(r["shape"]): r for r in int8_rows}
    d, f, v = FULL["d_model"], FULL["d_ff"], FULL["vocab_size"]
    layers = FULL["num_layers"]
    for label, m, head_m in (("128-bucket admission", BUCKETS[0], 1),
                             ("512-bucket admission", BUCKETS[1], 1),
                             ("decode step", SLOTS, SLOTS)):
        per = {(m, d, d): 4 * layers, (m, d, f): layers, (m, f, d): layers,
               (head_m, d, v): 1}
        check(sum(per.values()) == INT8_PER_PASS, "int8 pass %s" % per)

        def total(key):
            if any(by_shape[s].get(key) is None for s in per):
                return float("nan")
            return sum(by_shape[s][key] * c for s, c in per.items())

        warm = "" if m > quant_ops.DECODE_MAX_M else \
            " on a cold L2 (warm %.3f ms)" % total("warm_ms")
        print("[time] B3 per %s (%d launches): %.3f ms%s (profiler %.3f), "
              "bound %.3f ms; plain %.3f ms; _int_mm route %.3f ms; f32 "
              "torch.matmul %.3f ms" % (
                  label, INT8_PER_PASS, total("ms"), warm,
                  total("profiler_ms"), total("bound_ms"), total("plain_ms"),
                  total("library_ms"), total("f32_matmul_ms")))


def b1_check(y, s, ss, want, label):
    """B1's outputs against its plain version's (``want``), to B1_RTOL;
    prints and returns the error of y, in units of max|y|."""
    wy, ws, wss = want
    scale = float(wy.abs().max())
    mags = wy.abs().sum(dim=(0, 2, 3))
    count = wy.numel() // wy.shape[1]
    ey = float((y - wy).abs().max())
    es = float(((s - ws).abs() / mags).max())
    ess = float(((ss - wss).abs() / wss).max())
    var = ss / count - (s / count) ** 2
    wvar = wss / count - (ws / count) ** 2
    evar = float(((var - wvar).abs() / (wss / count)).max())
    print("[compare] conv_bn_stats %s: max_abs_err y %.3g (max|y| %.3g), "
          "sum %.3g, sumsq %.3g, variance %.3g (relative; tol %g)"
          % (label, ey, scale, es, ess, evar, B1_RTOL))
    check(ey <= B1_RTOL * scale and es <= B1_RTOL and ess <= B1_RTOL
          and evar <= B1_RTOL, "conv_bn_stats disagrees at %s" % label)
    return ey


def phase_compare_conv_bn(rng):
    """Kernel B1 against its plain version at every shape of the ResNet-50
    path (batch 256) and at ragged shapes; a second launch, on scratch
    that held NaN, gives the same bits; its autograd Function against
    autograd of the plain version with cotangents on y, sum and sumsq;
    and the probe T1 (the BN-apply + ReLU prologue, bf16, the tensor
    cores) against its plain version at the probe's three cases and at
    ragged ones, bitwise repeatable on partial sums that held NaN."""
    import torch
    from paddle_tpu_torch.ops import conv_bn
    batch = TRAIN["batch"]
    worst, worst_rel = 0.0, 0.0
    cases = [(batch, c, o, h, h) for c, o, h in B1_SHAPES] + list(B1_RAGGED)
    for n, c, o, h, w in cases:
        x = torch.randn(n, c, h, w, device="cuda")
        wt = torch.randn(o, c, 1, 1, device="cuda") * c ** -0.5
        got = conv_bn.conv_bn_stats_1x1(x, wt)
        # a second launch on scratch filled with NaN: a transposed-weight
        # or partial-sum slot the kernel fails to write shows in y or the
        # sums
        plan = conv_bn._plan(n, c, h * w, o)
        nan = [t.fill_(float("nan")) for t in conv_bn._scratch(x, o, plan)]
        again = conv_bn._launch(x, wt, plan, scratch=nan)
        want = conv_bn.conv_bn_stats_plain(x, wt)
        torch.cuda.synchronize()
        label = "N=%d C=%d O=%d %dx%d" % (n, c, o, h, w)
        err = b1_check(*got, want, label)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              "conv_bn_stats: two launches differ at %s" % label)
        worst = max(worst, err)
        worst_rel = max(worst_rel, err / float(want[0].abs().max()))
        del x, wt, got, nan, again, want
    print("[compare] conv_bn_stats: two launches bitwise equal at all %d "
          "shapes, the second on scratch that held NaN" % len(cases))
    # the autograd Function (B1 forward) against autograd of the plain
    # version, cotangents on all three outputs
    x = torch.randn(8, 256, 56, 56, device="cuda")
    wt = torch.randn(64, 256, 1, 1, device="cuda") * 256 ** -0.5
    cts = [torch.randn(8, 64, 56, 56, device="cuda"),
           torch.randn(64, device="cuda"), torch.randn(64, device="cuda")]
    grads = []
    for fn in (conv_bn.conv_bn_stats,
               lambda a, b: conv_bn.conv_bn_stats_plain(a, b)):
        xa = x.clone().requires_grad_()
        wa = wt.clone().requires_grad_()
        torch.autograd.backward(list(fn(xa, wa)), cts)
        grads.append((xa.grad, wa.grad))
    torch.cuda.synchronize()
    errs = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(*grads)]
    print("[compare] conv_bn_stats gradient (N=8 C=256 O=64 56x56, "
          "cotangents on y, sum, sumsq): Function vs autograd of the plain "
          "version, max_abs_err / max|grad| x %.3g, w %.3g (tol %g)"
          % (errs[0], errs[1], B1_RTOL))
    check(max(errs) <= B1_RTOL, "conv_bn_stats gradient disagrees")
    del x, wt, cts, grads
    t1 = 0.0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(T1_RAGGED[0][0])
    cases = [(name, r, c, o, None) for name, r, c, o in T1_CASES] + \
        [("ragged", r, c, o, gen) for r, c, o in T1_RAGGED]
    for name, r, c, o, g in cases:
        x = torch.randn(r, c, device="cuda", generator=g).bfloat16()
        a = (torch.rand(c, device="cuda", generator=g) + 0.5).bfloat16()
        b = (torch.randn(c, device="cuda", generator=g) * 0.1).bfloat16()
        w = (torch.randn(c, o, device="cuda", generator=g) * 0.05).bfloat16()
        y, s, ss = conv_bn.conv1x1_bn_relu(x, a, b, w)
        # a second call on partial sums that held NaN: a partial the
        # kernel fails to write shows in the sums
        plan = conv_bn._t1_plan(r, c, o)
        nan = torch.full((2, plan.row_tiles, o), float("nan"), device="cuda")
        again = conv_bn._launch_t1(x, a, b, w, plan, part=nan)
        wy, ws, wss = conv_bn.conv1x1_bn_relu_plain(x, a, b, w)
        torch.cuda.synchronize()
        yf, wyf = y.float(), wy.float()
        scale = float(wyf.abs().max())
        ey = float((yf - wyf).abs().max())
        es = float(((s - ws).abs() / wyf.abs().sum(0).clamp(min=1e-30))
                   .max())
        ess = float(((ss - wss).abs() / wss.clamp(min=1e-30)).max())
        label = "%s R=%d C=%d O=%d (tile %dx%d)" % (name, r, c, o, plan.bm,
                                                   plan.bn)
        print("[compare] conv1x1_bn_relu bf16 %s: max_abs_err y %.3g "
              "(max|y| %.3g, tol one bf16 step %.3g), sum %.3g, sumsq %.3g "
              "(relative; tol %g); a second call on NaN partials bitwise "
              "equal" % (label, ey, scale, scale * 2 ** -7, es, ess,
                         T1_SUM_RTOL))
        check(ey <= scale * 2 ** -7 and es <= T1_SUM_RTOL
              and ess <= T1_SUM_RTOL, "conv1x1_bn_relu disagrees at " + label)
        check(all(torch.equal(p, q) for p, q in zip((y, s, ss), again)),
              "conv1x1_bn_relu: two calls differ at " + label)
        t1 = max(t1, ey)
        del x, a, b, w, y, s, ss, wy, ws, wss, yf, wyf, nan, again
    return {"conv_bn_stats": worst, "conv_bn_stats_rel": worst_rel,
            "conv1x1_bn_relu": t1}


def small_resnet(fused, device):
    """A narrow bottleneck ResNet from the port's layers: 3x3 stem (3 ->
    8), a bottleneck to 16 channels at stride 1, one to 32 at stride 2
    (a strided 1x1 conv1 and shortcut beside B1's 1x1 convs), global
    average pool, fc to 10 classes; reference names, initialized from
    seed 0."""
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.models import resnet
    b = resnet._Build(fused, False, resolve_device(device))
    stem = resnet.conv_bn_layer(b, 3, 8, 3, 1, 1)
    blk1, ch = resnet.bottleneck(b, 8, 4, 1)
    blk2, ch = resnet.bottleneck(b, ch, 8, 2)
    model = resnet.ResNet(stem, False, [blk1, blk2], 10, ch, b)
    model.reset_parameters(0)
    return model


def phase_small_resnet(rng):
    """The small ResNet on the card (B1 in its path) against the same
    model on the CPU, from the same weights, over 3 Momentum steps; and
    fused against unfused on the card."""
    import torch
    from paddle_tpu_torch import optimizer, trainer
    img = rng.standard_normal((8, 3, 16, 16), dtype=np.float32)
    label = rng.integers(0, 10, (8, 1))
    init = [t.detach().numpy().copy() for t in
            small_resnet(True, "cpu").reference_tensors().values()]
    runs = {}
    for name, fused, dev in (("cpu", True, "cpu"), ("card", True, "cuda"),
                             ("card unfused", False, "cuda")):
        model = small_resnet(fused, dev)
        with torch.no_grad():     # the same slots in the same order
            for t, v in zip(model.reference_tensors().values(), init):
                t.copy_(torch.from_numpy(v))
        opt = optimizer.Momentum(model.reference_parameters(), 0.1, 0.9)
        x, y = torch.from_numpy(img).to(dev), torch.from_numpy(label).to(dev)
        reset_launches()
        losses = [float(trainer.train_step(model, opt, x, y)[0])
                  for _ in range(3)]
        launches = read_launches()["conv_bn_stats"]
        state = {n: t.detach().cpu().numpy()
                 for n, t in model.reference_tensors().items()}
        state.update({n: v.cpu().numpy()
                      for n, v in opt.accumulators().items()})
        runs[name] = (losses, state, launches)
    cpu, card, unfused = runs["cpu"], runs["card"], runs["card unfused"]
    errs = {n: float(np.linalg.norm(card[1][n] - v) /
                     max(np.linalg.norm(v), 1e-30))
            for n, v in cpu[1].items()}
    worst = max(errs, key=errs.get)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0]))
    print("[small-resnet] 3 Momentum steps, losses card %s cpu %s unfused "
          "card %s; card vs CPU: losses rel err %.3g, worst tensor %s rel "
          "err %.3g (tol %g); B1 launches on the card %d (fused), %d "
          "(unfused)" % ([round(v, 6) for v in card[0]],
                         [round(v, 6) for v in cpu[0]],
                         [round(v, 6) for v in unfused[0]], loss_err, worst,
                         errs[worst], SMALL_RESNET_RTOL, card[2],
                         unfused[2]))
    check(loss_err <= SMALL_RESNET_RTOL and errs[worst] <= SMALL_RESNET_RTOL,
          "small ResNet on the card disagrees with the CPU")
    check(card[2] == 3 * SMALL_B1_PER_STEP and unfused[2] == 0,
          "small ResNet B1 launches %d / %d" % (card[2], unfused[2]))
    fused_l, unfused_l = np.array(card[0]), np.array(unfused[0])
    check(np.allclose(fused_l, unfused_l, rtol=FUSED_UNFUSED_RTOL, atol=0),
          "fused vs unfused losses differ beyond rtol %g: %s %s"
          % (FUSED_UNFUSED_RTOL, fused_l, unfused_l))
    check(np.isfinite(fused_l).all() and fused_l[-1] < fused_l[0],
          "the small ResNet did not train: %s" % fused_l)


def phase_small_resnet_amp(rng):
    """The small ResNet unfused under amp bf16 (its conv2d and the fc's
    mul bfloat16 products, read from the flag at each step) on the card
    against the same model on the CPU over 3 Momentum steps: losses
    within SMALL_RESNET_AMP_RTOL, every parameter within 2 lr a step."""
    import torch
    from paddle_tpu_torch import optimizer, trainer
    img = rng.standard_normal((8, 3, 16, 16), dtype=np.float32)
    label = rng.integers(0, 10, (8, 1))
    init = [t.detach().numpy().copy() for t in
            small_resnet(False, "cpu").reference_tensors().values()]
    lr, steps, runs = 0.1, 3, {}
    for dev in ("cpu", "cuda"):
        model = small_resnet(False, dev)
        with torch.no_grad():
            for t, v in zip(model.reference_tensors().values(), init):
                t.copy_(torch.from_numpy(v))
        opt = optimizer.Momentum(model.reference_parameters(), lr, 0.9)
        x, y = torch.from_numpy(img).to(dev), torch.from_numpy(label).to(dev)
        dtypes = []
        model.stem.register_forward_hook(
            lambda mod, args, out: dtypes.append(out.dtype))
        with amp_flag("bfloat16"):
            losses = [float(trainer.train_step(model, opt, x, y)[0])
                      for _ in range(steps)]
        params = {n: p.detach().cpu().numpy()
                  for n, p in model.reference_parameters().items()}
        runs[dev] = (losses, params, dtypes)
    (cpu_l, cpu_p, _), (card_l, card_p, dtypes) = runs["cpu"], runs["cuda"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
    far = max(float(np.abs(card_p[n] - v).max()) for n, v in cpu_p.items())
    print("[small-resnet] amp bfloat16, unfused, 3 Momentum steps: losses "
          "card %s cpu %s (rel err %.3g, tol %g); parameters card vs CPU "
          "max %.3g lr (tol %d lr); the stem's output %s"
          % ([round(v, 6) for v in card_l], [round(v, 6) for v in cpu_l],
             loss_err, SMALL_RESNET_AMP_RTOL, far / lr, 2 * steps,
             dtypes[-1]))
    check(loss_err <= SMALL_RESNET_AMP_RTOL and far <= 2 * steps * lr,
          "the small ResNet under amp on the card disagrees with the CPU")
    check(dtypes == [torch.bfloat16] * steps,
          "the small ResNet under amp ran its convolutions in %s" % dtypes)
    check(np.isfinite(card_l).all() and card_l[-1] < card_l[0],
          "the small ResNet did not train under amp: %s" % card_l)


def phase_train(seed):
    """ResNet-50 training at bench.py's accelerator configuration in f32
    with fused_conv_bn on: warm-up steps, then TRAIN_STEPS timed steps
    (host clock around each step ended by a synchronize), every launch
    count at 0 just before the timed steps. Returns (model, optimizer,
    img, label, B1 shape counts per step, launches, stats)."""
    import torch
    from paddle_tpu_torch import config, optimizer, trainer
    from paddle_tpu_torch.models.resnet import resnet_imagenet
    from paddle_tpu_torch.ops import conv_bn
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    config.set_flags(fused_conv_bn=True)
    try:
        model = resnet_imagenet(TRAIN["depth"], TRAIN["class_dim"],
                                seed=seed, device="cuda")
    finally:
        config.set_flags(fused_conv_bn=False)
    opt = optimizer.Momentum(model.reference_parameters(), TRAIN["lr"],
                             TRAIN["momentum"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    batch, res = TRAIN["batch"], TRAIN["res"]
    img = torch.randn(batch, 3, res, res, device="cuda", generator=gen)
    label = torch.randint(0, TRAIN["class_dim"], (batch, 1), device="cuda",
                          generator=gen)
    nparam = sum(p.numel() for p in model.reference_parameters().values())
    # the (C, O, H) of every convolution the fused model routes to B1 in
    # one step, from forward hooks on its conv layers
    shapes = {}

    def record(layer, inputs, _output):
        x = inputs[0]
        if layer.fused and conv_bn.fusable(x, layer.weight, layer.stride,
                                           layer.padding):
            key = (x.shape[1], layer.weight.shape[0], x.shape[2])
            shapes[key] = shapes.get(key, 0) + 1

    hooks = [m.register_forward_hook(record) for m in model.conv_layers()]
    t0 = time.perf_counter()
    losses = [float(trainer.train_step(model, opt, img, label)[0])]
    first_s = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    for _ in range(TRAIN_WARMUP - 1):
        losses.append(float(trainer.train_step(model, opt, img, label)[0]))
    torch.cuda.synchronize()
    reset_launches()
    step_ms, accs = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, acc = trainer.train_step(model, opt, img, label)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        accs.append(float(acc))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    med = sorted(step_ms)[len(step_ms) // 2]
    ips = batch / med * 1e3
    mfu = ips * TRAIN_GFLOP_PER_IMAGE * 1e9 / F32_FLOPS
    mfu_bench = ips * TRAIN_GMAC_PER_IMAGE * 1e9 / F32_FLOPS
    print("[train] ResNet-50 f32, fused_conv_bn on, %dx%d, batch %d, "
          "Momentum(%g, %g), %d parameters; first step %.2f s (B1 shapes "
          "per step (C, O, H): %s)"
          % (res, res, batch, TRAIN["lr"], TRAIN["momentum"], nparam,
             first_s, dict(sorted(shapes.items()))))
    print("[train] %d timed steps after %d warm-up: median step %.2f ms, "
          "%.1f images/s, MFU %.4f of %.0f TFLOP/s f32 (%.1f GFLOP per "
          "image; %.4f at bench.py's count of %.1f G multiply-adds, which "
          "it labels GFLOP); steps ms %s" % (
              TRAIN_STEPS, TRAIN_WARMUP, med, ips, mfu, F32_FLOPS / 1e12,
              TRAIN_GFLOP_PER_IMAGE, mfu_bench, TRAIN_GMAC_PER_IMAGE,
              [round(t, 2) for t in step_ms]))
    print("[train] losses %s; accuracy of the timed steps %s; peak memory "
          "allocated %.2f GB; B1 launches in the timed steps %d (%d per "
          "step)" % ([round(v, 4) for v in losses], accs, peak / 1e9,
                     launches["conv_bn_stats"],
                     launches["conv_bn_stats"] // TRAIN_STEPS))
    check(np.isfinite(losses).all(), "non-finite training loss")
    check(sum(shapes.values()) == B1_PER_STEP
          and sorted(shapes) == sorted((c, o, h) for c, o, h in B1_SHAPES),
          "B1 shapes of a step %s" % shapes)
    check(launches["conv_bn_stats"] == B1_PER_STEP * TRAIN_STEPS,
          "B1 launches %d != %d x %d steps" % (launches["conv_bn_stats"],
                                               B1_PER_STEP, TRAIN_STEPS))
    check(all(v == 0 for k, v in launches.items() if k != "conv_bn_stats"),
          "the training path launched another kernel: %s" % launches)
    stats = dict(step_ms=med, images_per_s=ips, mfu=mfu,
                 mfu_bench_count=mfu_bench, peak_bytes=peak)
    return model, opt, img, label, shapes, launches, stats


def profile_step(label, fn, kernel, markers, top=10):
    """torch.profiler over ``fn()`` (one training step): device-busy
    share, the share of the busy time in the kernels whose names hold one
    of ``markers`` (``kernel`` names them), top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        uncounted(fn)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    busy = sum(by_name.values())
    if not busy:
        print("[profile] %s: the profiler saw no device time (not "
              "measured)" % label)
        return
    mine = sum(us for n, us in by_name.items()
               if any(m in n for m in markers))
    print("[profile] %s: wall %.3f ms, device busy %.3f ms (%.1f%%); %s "
          "%.3f ms, %.1f%% of busy"
          % (label, wall_us / 1e3, busy / 1e3, 100 * busy / wall_us, kernel,
             mine / 1e3, 100 * mine / busy))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print("[profile]   %6.1f%% %9.3f ms  %s"
              % (100 * us / busy, us / 1e3, name[:110]))


def phase_profile_train(model, opt, img, label):
    """One ResNet-50 training step under the profiler; B1's share."""
    from paddle_tpu_torch import trainer
    profile_step("ResNet-50 training step",
                 lambda: trainer.train_step(model, opt, img, label),
                 "B1 (its three launches)",
                 ("w_transpose_kernel", "conv1x1_f32_stats_kernel",
                  "stats_finish_kernel"))


def phase_time_conv_bn(launches, errs, shapes):
    """B1 at each of its path shapes (batch 256) and T1 at the probe's
    cases: the kernel's time, the plain version's and the library
    route's (cuDNN F.conv2d plus the two sums for B1, the torch route for
    T1), each by the profiler and between CUDA events, and the bound from
    the shapes."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import conv_bn
    from paddle_tpu_torch.probes.conv_bn import torch_route
    rows = []
    batch = TRAIN["batch"]
    print("[time] conv_bn_stats, conv1x1_bn_relu: each time between CUDA "
          "events over calls queued behind a sleep kernel, the profiler's "
          "kernel sum beside it")
    for c, o, h in B1_SHAPES:
        x = torch.randn(batch, c, h, h, device="cuda")
        wt = torch.randn(o, c, 1, 1, device="cuda") * c ** -0.5
        ms, profiler_ms = two_clocks(functools.partial(
            conv_bn.conv_bn_stats_1x1, x, wt))
        plain_ms, plain_profiler_ms = two_clocks(
            lambda: conv_bn.conv_bn_stats_plain(x, wt))

        def library():
            y = F.conv2d(x, wt)
            return y, y.sum(dim=(0, 2, 3)), (y * y).sum(dim=(0, 2, 3))

        lib_ms, lib_profiler_ms = two_clocks(library)
        r = batch * h * h
        nbytes = 4 * (r * c + o * c + r * o + 2 * o)
        bound, bound_by = roofline_ms(nbytes, 2 * r * c * o + 3 * r * o)
        rows.append(dict(
            name="conv_bn_stats", route="cuda",
            source="paddle_tpu_torch/csrc/conv_bn_stats.cu",
            replaces="paddle_tpu/ops/pallas_conv_bn.py:128",
            launches=launches["conv_bn_stats"],
            max_abs_err=errs["conv_bn_stats"],
            max_rel_err=errs["conv_bn_stats_rel"], ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=bound_by, library_ms=lib_ms,
            shape=[batch, c, o, h, h],
            tile=list(conv_bn._plan(batch, c, h * h, o)[1:3]),
            launches_per_step=shapes.get((c, o, h), 0),
            profiler_ms=profiler_ms, plain_profiler_ms=plain_profiler_ms,
            library_profiler_ms=lib_profiler_ms))
        del x, wt
    for name, r, c, o in T1_CASES:
        x = torch.randn(r, c, device="cuda").bfloat16()
        a = (torch.rand(c, device="cuda") + 0.5).bfloat16()
        b = (torch.randn(c, device="cuda") * 0.1).bfloat16()
        w = (torch.randn(c, o, device="cuda") * 0.05).bfloat16()
        ms, profiler_ms = two_clocks(functools.partial(
            conv_bn.conv1x1_bn_relu, x, a, b, w))
        plain_ms, plain_profiler_ms = two_clocks(
            lambda: conv_bn.conv1x1_bn_relu_plain(x, a, b, w))
        lib_ms, lib_profiler_ms = two_clocks(
            lambda: torch_route(x, a, b, w))
        nbytes = 2 * (r * c + 2 * c + c * o + r * o) + 4 * 2 * o
        # bf16 products with f32 accumulation: the tensor cores' rate
        bound, bound_by = roofline_ms(nbytes, 2 * r * c * o + 3 * r * c
                                      + 3 * r * o, peak=BF16_FLOPS)
        plan = conv_bn._t1_plan(r, c, o)
        rows.append(dict(
            name="conv1x1_bn_relu", route="cuda",
            source="paddle_tpu_torch/csrc/conv1x1_bn_relu.cu",
            replaces="tools/fused_conv_bn_probe.py:49",
            launches=launches["conv1x1_bn_relu"],
            launches_in="not on a path (probe T1)",
            max_abs_err=errs["conv1x1_bn_relu"], ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=bound_by, library_ms=lib_ms,
            library_route="torch route: bf16 prologue, torch.mm(z, w, "
            "out_dtype=torch.float32), the cast, the two sums",
            shape=[r, c, o], tile=[plan.bm, plan.bn], dtype="bfloat16",
            profiler_ms=profiler_ms, plain_profiler_ms=plain_profiler_ms,
            library_profiler_ms=lib_profiler_ms))
        del x, a, b, w
    for r in rows:
        tile = " (tile %dx%d)" % tuple(r["tile"]) if "tile" in r else ""
        print("[time] %s %s%s: %s; bound %.4f ms by %s; plain %s; library "
              "%s" % (r["name"], r["shape"], tile, clocks(r, "kernel"),
                      r["bound_ms"], r["bound_by"], clocks(r, "plain"),
                      clocks(r, "library")))
    b1 = [r for r in rows if r["name"] == "conv_bn_stats"]

    def per_step(key):
        return sum(r[key] * r["launches_per_step"] for r in b1)

    print("[time] B1 per training step (30 launches): %.3f ms (profiler "
          "%.3f), bound %.3f ms; plain %.3f ms; cuDNN + sums %.3f ms"
          % (per_step("ms"), per_step("profiler_ms"), per_step("bound_ms"),
             per_step("plain_ms"), per_step("library_ms")))
    print("[time] conv1x1_bn_relu (T1): no single PyTorch call computes "
          "it; its library figure is the torch route (the reference probe's "
          "xla_path: the prologue in bf16 ops, torch.mm with out_dtype "
          "float32, the cast, the sums; probes/conv_bn.py torch_route)")
    return rows


def resnet_program(depth, res, class_dim, lr, momentum, fused=False,
                   recompute=False, cifar=False):
    """(main, startup, loss name, names of the running statistics) of the
    ResNet bench.py builds, through the port's front end: ``resnet_imagenet``
    (or ``resnet_cifar10``) and ``Momentum(lr, momentum).minimize``, built
    under the ``fused_conv_bn`` flag as given."""
    from paddle_tpu_torch import config, core, layers, optimizer
    from paddle_tpu_torch.models import resnet
    config.set_flags(fused_conv_bn=fused)
    try:
        main, startup = core.Program(), core.Program()
        with core.unique_name.guard(), core.program_guard(main, startup):
            img = layers.data("img", shape=[3, res, res])
            label = layers.data("label", shape=[1], dtype="int64")
            build = resnet.resnet_cifar10 if cifar else \
                resnet.resnet_imagenet
            loss = build(img, label, depth=depth, class_dim=class_dim,
                         recompute=recompute)[0]
            optimizer.Momentum(lr, momentum).minimize(loss, startup)
    finally:
        config.set_flags(fused_conv_bn=False)
    stats = sorted(n for n, v in main.global_block().vars.items()
                   if v.persistable and n.endswith((".global_0", ".global_1")))
    return main, startup, loss.name, stats


def bench_feed(batch, res, classes, device):
    """bench.py's feed: RandomState(0) images, then int32 labels in
    [0, 1000), put on ``device`` once."""
    import torch
    rs = np.random.RandomState(0)
    img = rs.randn(batch, 3, res, res).astype("float32")
    label = rs.randint(0, 1000, (batch, 1)).astype(np.int32) % classes
    return {"img": torch.from_numpy(img).to(device),
            "label": torch.from_numpy(label).to(device)}


def scope_copy(scope, device="cuda"):
    """A new Scope holding a copy of each tensor of ``scope``."""
    from paddle_tpu_torch import core
    out = core.Scope()
    for n, v in scope.items():
        out.set_var(n, v.detach().to(device).clone())
    return out


def rel_dist(a, b):
    """||a - b|| / ||b|| in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def timed_steps(exe, main, feed, loss, scope, steps):
    """``steps`` Executor.run calls, each ended by a synchronize: (the
    host time of each in ms, the losses)."""
    import torch
    times, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out))
    return times, losses


def phase_small_program(seed):
    """ResNet-8 for CIFAR built by the front end, serialized to JSON and
    loaded back, run from one set of weights on the card and on the CPU
    for 2 Momentum steps, amp off and on."""
    import torch
    from paddle_tpu_torch import core
    from paddle_tpu_torch.core import serialization
    cfg = SMALL_PROGRAM
    main, startup, loss, _ = resnet_program(
        cfg["depth"], cfg["res"], 10, cfg["lr"], 0.9, cifar=True)
    text = json.dumps(serialization.program_to_dict(main))
    main = serialization.program_from_dict(json.loads(text))
    startup.random_seed = seed
    init = core.Scope()
    core.Executor(device="cpu").run(startup, scope=init)
    feed = bench_feed(cfg["batch"], cfg["res"], 10, "cpu")
    for amp in (None, "bfloat16"):
        runs = {}
        for dev in ("cpu", "cuda"):
            scope = scope_copy(init, dev)
            exe = core.Executor(device=dev)
            with amp_flag(amp):
                losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                        scope=scope)[0])
                          for _ in range(cfg["steps"])]
            runs[dev] = (losses, {n: v.cpu() for n, v in scope.items()})
        (cpu_l, cpu_s), (card_l, card_s) = runs["cpu"], runs["cuda"]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
        floats = [n for n, v in cpu_s.items() if v.is_floating_point()]
        errs = {n: rel_dist(card_s[n], cpu_s[n]) for n in floats}
        worst = max(errs, key=errs.get)
        params = [n for n in floats if ".w_" in n and "_acc_" not in n]
        far = max(float((card_s[n] - cpu_s[n]).abs().max()) for n in params)
        print("[small-program] ResNet-8 program (%d KB of JSON), amp %s, %d "
              "Momentum steps: losses card %s cpu %s (rel err %.3g); worst "
              "tensor %s rel err %.3g; parameters card vs CPU max %.3g lr"
              % (len(text) // 1024, amp, cfg["steps"],
                 [round(v, 6) for v in card_l], [round(v, 6) for v in cpu_l],
                 loss_err, worst, errs[worst], far / cfg["lr"]))
        if amp is None:
            check(loss_err <= SMALL_RESNET_RTOL and
                  errs[worst] <= SMALL_RESNET_RTOL,
                  "the small program on the card disagrees with the CPU")
        else:
            check(loss_err <= SMALL_RESNET_AMP_RTOL and
                  far <= 2 * cfg["steps"] * cfg["lr"],
                  "the small program under amp on the card disagrees with "
                  "the CPU")
        check(np.isfinite(card_l).all() and
              not all(torch.equal(card_s[n], init.find_var(n).cpu())
                      for n in params),
              "the small program did not train: %s" % card_l)


def phase_program_train_fused(seed, module_stats):
    """ResNet-50 f32 with fused_conv_bn on through the program path: one
    step from the startup program's weights against the nn.Module route
    from the same weights (loss and running statistics within
    PROGRAM_ROUTE_RTOL), then warm-up and PROGRAM_FUSED_STEPS timed steps
    with every count at 0 just before them: B1 launches 30 times a step
    through the executor's conv2d_bn op, and nothing else."""
    import torch
    from paddle_tpu_torch import config, core, io, optimizer, trainer
    from paddle_tpu_torch.models.resnet import resnet_imagenet
    torch.cuda.empty_cache()
    cfg = TRAIN
    main, startup, loss, stats = resnet_program(
        cfg["depth"], cfg["res"], cfg["class_dim"], cfg["lr"],
        cfg["momentum"], fused=True)
    startup.random_seed = seed
    exe = core.Executor(device="cuda")
    init = core.Scope()
    exe.run(startup, scope=init)
    feed = bench_feed(cfg["batch"], cfg["res"], cfg["class_dim"], "cuda")
    config.set_flags(fused_conv_bn=True)
    try:
        model = resnet_imagenet(cfg["depth"], cfg["class_dim"],
                                device="cuda")
    finally:
        config.set_flags(fused_conv_bn=False)
    opt = optimizer.Momentum(model.reference_parameters(), 1.0,
                             cfg["momentum"])
    io.params_from_jax({n: v.cpu().numpy() for n, v in init.items()},
                       model=model, optimizer=opt)
    mod_loss = float(trainer.train_step(model, opt, feed["img"],
                                        feed["label"])[0])
    mod_stats = {n: t.detach().clone()
                 for n, t in model.reference_tensors().items() if n in stats}
    del model, opt
    scope = scope_copy(init)
    del init
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times, losses = timed_steps(exe, main, feed, loss, scope, 1)
    loss_err = abs(losses[0] - mod_loss) / abs(mod_loss)
    stat_err = max(rel_dist(scope.find_var(n), mod_stats[n]) for n in stats)
    print("[program-train fused] ResNet-50 f32, fused_conv_bn on, program of "
          "%d ops (%d conv2d_bn); one step from the startup program's "
          "weights: loss executor %.6f, nn.Module %.6f (rel err %.3g), "
          "running statistics rel err %.3g (tol %g)"
          % (len(main.global_block().ops),
             sum(op.type == "conv2d_bn" for op in main.global_block().ops),
             losses[0], mod_loss, loss_err, stat_err, PROGRAM_ROUTE_RTOL))
    check(loss_err <= PROGRAM_ROUTE_RTOL and stat_err <= PROGRAM_ROUTE_RTOL,
          "the executor and the nn.Module route disagree on one step")
    timed_steps(exe, main, feed, loss, scope, PROGRAM_FUSED_WARMUP - 1)
    reset_launches()
    times, more = timed_steps(exe, main, feed, loss, scope,
                              PROGRAM_FUSED_STEPS)
    launches = read_launches()
    losses += more
    peak = torch.cuda.max_memory_allocated()
    med = sorted(times)[len(times) // 2]
    print("[program-train fused] %d timed steps after %d warm-up: median "
          "step %.2f ms (%.1f images/s) beside the nn.Module [train] step "
          "%.2f ms of this run: the executor costs %.2f ms a step more; "
          "peak memory allocated %.2f GB ([train] %.2f GB); B1 launches in "
          "the timed steps %d (%d per step); steps ms %s; losses %s"
          % (PROGRAM_FUSED_STEPS, PROGRAM_FUSED_WARMUP, med,
             cfg["batch"] / med * 1e3, module_stats["step_ms"],
             med - module_stats["step_ms"], peak / 1e9,
             module_stats["peak_bytes"] / 1e9, launches["conv_bn_stats"],
             launches["conv_bn_stats"] // PROGRAM_FUSED_STEPS,
             [round(t, 2) for t in times], [round(v, 4) for v in losses]))
    check(np.isfinite(losses).all(), "non-finite loss on the program path")
    check(launches["conv_bn_stats"] == B1_PER_STEP * PROGRAM_FUSED_STEPS,
          "B1 launches through conv2d_bn %d != %d x %d steps"
          % (launches["conv_bn_stats"], B1_PER_STEP, PROGRAM_FUSED_STEPS))
    check(all(v == 0 for k, v in launches.items() if k != "conv_bn_stats"),
          "the program path launched another kernel: %s" % launches)
    return dict(step_ms=med, peak_bytes=peak, launches=launches)


def phase_program_train(seed):
    """ResNet-50 as bench.py trains it on the accelerator, through the
    program path under amp bf16 with fused_conv_bn off: 5 warm-up and 30
    timed Executor.run calls, one synchronize closing the window. Returns
    what [program-train recompute] compares with: the weights after
    startup, the first step's loss and running statistics, the step time
    and peak memory."""
    import torch
    from paddle_tpu_torch import core
    torch.cuda.empty_cache()
    cfg = TRAIN
    t0 = time.perf_counter()
    main, startup, loss, stats = resnet_program(
        cfg["depth"], cfg["res"], cfg["class_dim"], cfg["lr"],
        cfg["momentum"])
    build_s = time.perf_counter() - t0
    startup.random_seed = seed
    exe = core.Executor(device="cuda")
    scope = core.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init = scope_copy(scope)
    feed = bench_feed(cfg["batch"], cfg["res"], cfg["class_dim"], "cuda")
    nparam = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with amp_flag("bfloat16"):
        t0 = time.perf_counter()
        first = float(exe.run(main, feed=feed, fetch_list=[loss],
                              scope=scope, return_numpy=False)[0])
        first_s = time.perf_counter() - t0
        first_stats = {n: scope.find_var(n).clone() for n in stats}
        for _ in range(PROGRAM_WARMUP - 1):
            outs = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                           return_numpy=False)
        float(outs[0])
        t0 = time.perf_counter()
        for _ in range(PROGRAM_STEPS):
            outs = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                           return_numpy=False)
        final = float(outs[0])   # one sync closes the window
        dt = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    ips = cfg["batch"] * PROGRAM_STEPS / dt
    ms = dt / PROGRAM_STEPS * 1e3
    mfu = ips * TRAIN_GFLOP_PER_IMAGE * 1e9 / BF16_FLOPS
    ops = main.global_block().ops
    print("[program-train] ResNet-50 program as bench.py builds it: %d ops "
          "(%d conv2d, %d batch_norm, %d vjp_grad, %d momentum), %d "
          "parameters; built in %.2f s, startup on the card %.2f s (seed "
          "%d), first step %.2f s" % (
              len(ops), sum(o.type == "conv2d" for o in ops),
              sum(o.type == "batch_norm" for o in ops),
              sum(o.type == "vjp_grad" for o in ops),
              sum(o.type == "momentum" for o in ops), nparam, build_s,
              init_s, seed, first_s))
    print("[program-train] amp bfloat16, fused_conv_bn off, %dx%d, batch "
          "%d, Momentum(%g, %g): %d warm-up and %d timed Executor.run, one "
          "synchronize: %.2f ms/step, %.1f images/s, bf16 MFU %.4f (%.1f "
          "GFLOP an image at %.0f TFLOP/s); peak memory allocated %.2f GB; "
          "loss first %.4f, final %.4f; kernel launches %s"
          % (cfg["res"], cfg["res"], cfg["batch"], cfg["lr"],
             cfg["momentum"], PROGRAM_WARMUP, PROGRAM_STEPS, ms, ips, mfu,
             TRAIN_GFLOP_PER_IMAGE, BF16_FLOPS / 1e12, peak / 1e9, first,
             final, {k: v for k, v in launches.items() if v}))
    check(np.isfinite(final) and final < first,
          "the program did not train: loss %s then %s" % (first, final))
    check(all(v == 0 for v in launches.values()),
          "the unfused bf16 program launched a port kernel: %s" % launches)
    with amp_flag("bfloat16"):
        profile_step("[program-train] one Executor.run",
                     lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                     scope=scope, return_numpy=False),
                     "torch's elementwise and reduction passes",
                     ("elementwise_kernel", "reduce_kernel"))
    del scope
    return dict(init=init, first=first, first_stats=first_stats,
                stats=stats, ms=ms, peak_bytes=peak, images_per_s=ips,
                mfu=mfu)


def phase_program_train_recompute(seed, plain):
    """[program-train] with each residual block recomputed for its
    gradient (16 recompute_block ops): one step from the same weights
    gives the plain program's loss and running statistics (updated once),
    then the step time and peak memory beside [program-train]'s."""
    import torch
    from paddle_tpu_torch import core
    torch.cuda.empty_cache()
    cfg = TRAIN
    main, _, loss, stats = resnet_program(
        cfg["depth"], cfg["res"], cfg["class_dim"], cfg["lr"],
        cfg["momentum"], recompute=True)
    check(stats == plain["stats"], "recompute changed the statistics' names")
    exe = core.Executor(device="cuda")
    scope = plain.pop("init")
    feed = bench_feed(cfg["batch"], cfg["res"], cfg["class_dim"], "cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with amp_flag("bfloat16"):
        _, first = timed_steps(exe, main, feed, loss, scope, 1)
        loss_err = abs(first[0] - plain["first"]) / abs(plain["first"])
        stat_err = max(rel_dist(scope.find_var(n), plain["first_stats"][n])
                       for n in stats)
        timed_steps(exe, main, feed, loss, scope,
                    PROGRAM_RECOMPUTE_WARMUP - 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROGRAM_RECOMPUTE_STEPS):
            outs = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                           return_numpy=False)
        final = float(outs[0])
        ms = (time.perf_counter() - t0) / PROGRAM_RECOMPUTE_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated()
    print("[program-train recompute] %d recompute_block ops: first step "
          "loss %.6f vs %.6f without (rel err %.3g), running statistics "
          "after it rel err %.3g (tol %g); %d timed steps: %.2f ms/step "
          "(%.1f images/s) beside %.2f ms without; peak memory allocated "
          "%.2f GB beside %.2f GB without; final loss %.4f"
          % (sum(op.type == "recompute_block"
                 for op in main.global_block().ops), first[0],
             plain["first"], loss_err, stat_err, PROGRAM_ROUTE_RTOL,
             PROGRAM_RECOMPUTE_STEPS, ms, cfg["batch"] / ms * 1e3,
             plain["ms"], peak / 1e9, plain["peak_bytes"] / 1e9, final))
    check(loss_err <= PROGRAM_ROUTE_RTOL and stat_err <= PROGRAM_ROUTE_RTOL,
          "recompute changed the step's loss or running statistics")
    check(np.isfinite(final), "non-finite loss with recompute")
    check(all(v == 0 for v in read_launches().values()),
          "the recomputed bf16 program launched a port kernel")
    return dict(ms=ms, peak_bytes=peak)


def pipeline_program(cfg, fused=True):
    """(main, startup, loss) of bench.py's bench_resnet_pipeline on the
    accelerator: ResNet-50 at 224 x 224 whose feeds are declared on the
    wire, ``img`` uint8 widened by 1/255 on the card and ``label`` int64
    crossing as int32, Momentum(0.1, 0.9); fused_conv_bn as given."""
    from paddle_tpu_torch import config, core, layers, optimizer
    from paddle_tpu_torch.models import resnet
    config.set_flags(fused_conv_bn=fused)
    try:
        main, startup = core.Program(), core.Program()
        with core.unique_name.guard(), core.program_guard(main, startup):
            img = layers.data("img", shape=[3, cfg["res"], cfg["res"]],
                              wire_dtype="uint8", scale=PIPELINE_SCALE)
            label = layers.data("label", shape=[1], dtype="int64",
                                wire_dtype="int32")
            loss = resnet.resnet_imagenet(img, label, depth=cfg["depth"],
                                          class_dim=cfg["class_dim"])[0]
            optimizer.Momentum(cfg["lr"], cfg["momentum"]).minimize(
                loss, startup)
    finally:
        config.set_flags(fused_conv_bn=False)
    return main, startup, loss


def pipeline_batches(cfg):
    """bench.py's host batches: RandomState(0) uint8 images and int32
    labels in [0, 1000), three of them."""
    rs = np.random.RandomState(0)
    b, r = cfg["batch"], cfg["res"]
    return [{"img": rs.randint(0, 256, (b, 3, r, r), "int64")
             .astype("uint8"),
             "label": rs.randint(0, 1000, (b, 1)).astype("int32")}
            for _ in range(3)]


def scope_state(scope):
    """{name: a copy of the tensor} of every tensor in ``scope``."""
    import torch
    return {n: v.detach().clone() for n, v in scope.items()
            if isinstance(v, torch.Tensor)}


def bitwise_diff(a, b):
    """The names whose tensors differ in bits (or dtype, or are missing)
    between two {name: tensor} dicts."""
    import torch

    def bits(t):
        return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)

    return sorted(n for n in set(a) | set(b)
                  if n not in a or n not in b or a[n].dtype != b[n].dtype
                  or a[n].shape != b[n].shape
                  or not torch.equal(bits(a[n]), bits(b[n])))


def wire_copies(trace_path, nbytes):
    """From a chrome trace of torch.profiler: the host-to-device copies
    of ``nbytes`` bytes as (name, stream), the streams the kernels ran
    on, every host-to-device copy as (name, bytes, stream), and the
    share of the window from the first of those copies (or the first
    kernel) to the last kernel's end in which a kernel ran."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    copies, kernel_streams, h2d, spans, starts = [], set(), [], [], []
    for e in events:
        args = e.get("args") or {}
        if e.get("cat") == "kernel":
            kernel_streams.add(args.get("stream"))
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        elif e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", ""):
            h2d.append((e["name"], args.get("bytes"), args.get("stream")))
            if args.get("bytes") == nbytes:
                copies.append((e["name"], args.get("stream")))
                starts.append(float(e["ts"]))
    if starts:
        spans = [sp for sp in spans if sp[0] >= min(starts)]
    busy, end = 0.0, None
    for t0, t1 in sorted(spans):
        if end is None or t0 > end:
            busy, end = busy + t1 - t0, t1
        elif t1 > end:
            busy, end = busy + t1 - end, t1
    window = max(t for _, t in spans) - min(t for t, _ in spans) \
        if spans else 0.0
    return copies, kernel_streams, h2d, busy / window if window else 0.0


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic convolution algorithms for a bitwise check
    (its default backward algorithms may sum in another order on each
    run); restored after."""
    import torch
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = prev


class _Recorder:
    """Wraps ``reader.staging.StagedReader`` so the readers Trainer.train
    makes are kept, with what their arena was when made."""

    def __init__(self):
        from paddle_tpu_torch.reader import staging
        self.staging, self.made = staging, []
        real = self.real = staging.StagedReader
        made = self.made

        class Recording(real):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                arena = self._arena
                made.append(dict(
                    reader=self, arena_active=self.arena_active,
                    pinned=arena is not None and arena.block.is_pinned()
                    and arena.tensor(64, 64).is_pinned(),
                    stream=self._stream))
        staging.StagedReader = Recording

    def close(self):
        self.staging.StagedReader = self.real


def phase_pipeline(seed):
    """bench.py's bench_resnet_pipeline on the accelerator, through the
    port's Trainer.train and staged input pipeline: ResNet-50 at 224,
    batch 8, fused_conv_bn on, Momentum(0.1, 0.9), uint8 images and int32
    labels packed into one pinned block per batch (``packed_feeds`` and
    ``telemetry`` on). Checks: exactly one host-to-device copy per batch,
    Pinned -> Device on a stream other than the step's kernels', B1 30
    times a step; one Trainer step from a packed uint8 batch equal to the
    bit to one Executor.run fed the batch widened on the host; a step
    resumed from a checkpoint equal to the bit to the uninterrupted one.
    Times after bench.py's recipe: compute (the step on a widened feed
    already on the card), the pinned wire copy (median of 4 before and 4
    after the pass), the pipeline (Trainer.train over 16 steps), the
    overlap max(compute, h2d) / pipeline and images/s."""
    import os
    import shutil
    import tempfile
    import torch
    from paddle_tpu_torch import config, core
    from paddle_tpu_torch.core import ingest
    from paddle_tpu_torch.reader import staging
    from paddle_tpu_torch.trainer import EndIteration, Trainer
    torch.cuda.empty_cache()
    cfg = PIPELINE
    steps = cfg["steps"]
    main, startup, loss = pipeline_program(cfg)
    startup.random_seed = seed
    init = core.Scope()
    core.Executor(device="cuda").run(startup, scope=init)
    hosts = pipeline_batches(cfg)

    def widened(hb):
        # the batch widened on the host: one rounding of u8 * f32(1/255)
        return {"img": torch.from_numpy(
            hb["img"].astype(np.float32) * np.float32(PIPELINE_SCALE)),
            "label": torch.from_numpy(hb["label"])}

    def trainer(scope, resume=False, **kw):
        # on a copy of the startup's weights; ``resume``: on a fresh
        # scope, the startup program then the newest checkpoint
        tr = Trainer(loss, main_program=main, startup_program=startup,
                     async_metrics=True, device="cuda", **kw)
        if resume:
            with core.scope_guard(scope):
                tr.startup()
        else:
            tr._initialized = True
        return tr

    def train(tr, scope, batches, events=None):
        with core.scope_guard(scope):
            tr.train(lambda: iter([dict(b) for b in batches]),
                     num_passes=1, event_handler=events)

    prev = {k: config.get_flag(k) for k in ("packed_feeds", "telemetry")}
    config.set_flags(packed_feeds=True, telemetry=True)
    rec = _Recorder()
    ckpt = tempfile.mkdtemp(prefix="pipeline_ckpt_")
    try:
        # the feeds a packed batch gives the program on the card, against
        # the batch widened on the host
        exe = core.Executor(device="cuda")
        pb = ingest.pack_feed(hosts[0])[0]
        pb.buffer = torch.from_numpy(pb.buffer).cuda()
        fed = exe._unpack(pb, main.global_block())
        differ = bitwise_diff(fed, widened(hosts[0]))
        print("[pipeline] a packed batch unpacked and widened on the card: "
              "%s; %d differ in bits from the batch widened on the host %s"
              % ({k: (tuple(v.shape), str(v.dtype)) for k, v in fed.items()},
                 len(differ), differ))
        check(not differ, "the packed feeds are not bitwise the host-widened "
              "ones")
        # one packed uint8 step against one Executor.run of the batch
        # widened on the host, from the same weights (cuDNN's
        # deterministic algorithms: its default ones may differ run to run)
        with deterministic_cudnn():
            packed_scope = scope_copy(init)
            train(trainer(packed_scope), packed_scope, hosts[:1])
            states = []
            for _ in range(2):
                host_scope = scope_copy(init)
                exe.run(main, feed={k: v.cuda() for k, v in
                                    widened(hosts[0]).items()},
                        fetch_list=[loss], scope=host_scope)
                states.append(scope_state(host_scope))
        differ = bitwise_diff(scope_state(packed_scope), states[0])
        print("[pipeline] one Trainer step from a packed uint8 batch vs "
              "Executor.run of the batch widened on the host, same weights, "
              "deterministic cuDNN: %d tensors, %d differ in bits %s (two "
              "host-widened runs: %d differ)"
              % (len(states[0]), len(differ), differ[:5],
                 len(bitwise_diff(*states))))
        check(not differ, "the packed uint8 step is not bitwise the "
              "widened f32 step")
        del packed_scope, host_scope, states

        # a checkpoint at step 4 resumed by a fresh Trainer: step 5
        # equal to the bit to the uninterrupted run's step 5
        with deterministic_cudnn():
            n = cfg["ckpt_every"]
            run_dir, resume_dir = (os.path.join(ckpt, d)
                                   for d in ("run", "resume"))
            whole = scope_copy(init)
            tr = trainer(whole, checkpoint_dir=run_dir,
                         checkpoint_every_n_steps=n)
            batches = [hosts[i % len(hosts)] for i in range(n + 1)]
            t0 = time.perf_counter()
            train(tr, whole, batches[:n])
            save_s = time.perf_counter() - t0
            shutil.copytree(run_dir, resume_dir)
            train(tr, whole, batches[n:])
            fresh = core.Scope()
            t0 = time.perf_counter()
            tr2 = trainer(fresh, resume=True, checkpoint_dir=resume_dir)
            load_s = time.perf_counter() - t0
            check(tr2.step_id == n, "the fresh Trainer resumed at step %d, "
                  "not %d" % (tr2.step_id, n))
            train(tr2, fresh, batches[n:])
            differ = bitwise_diff(scope_state(whole), scope_state(fresh))
            ckpt_mb = sum(os.path.getsize(os.path.join(dp, f))
                          for dp, _, fs in os.walk(
                              os.path.join(resume_dir, "checkpoint_%d" % n))
                          for f in fs) / 1e6
            print("[pipeline] checkpoint at step %d (%.1f MB, %d train steps "
                  "and the saves %.2f s), loaded by a fresh Trainer (startup "
                  "and load %.2f s), step %d: %d of %d tensors differ in bits "
                  "from the uninterrupted run %s"
                  % (n, ckpt_mb, n, save_s, load_s, n + 1, len(differ),
                     len(scope_state(whole)), differ[:5]))
        check(not differ, "the step resumed from a checkpoint is not "
              "bitwise the uninterrupted one")
        del whole, fresh, tr, tr2

        # compute only: the widened batch resident on the card
        scope = scope_copy(init)
        tr = trainer(scope)
        dev_feed = {k: v.cuda() for k, v in widened(hosts[0]).items()}
        with core.scope_guard(scope):
            float(tr._train_feed(dev_feed)["loss"])
            t0 = time.perf_counter()
            for _ in range(steps):
                m = tr._train_feed(dev_feed)
            float(m["loss"])
            compute_ms = (time.perf_counter() - t0) / steps * 1e3

        # the pinned wire copy of one packed batch, bracketed
        pb, _ = ingest.pack_feed(hosts[0])
        wire_nbytes = pb.nbytes
        pinned = torch.from_numpy(pb.buffer.reshape(-1)).pin_memory()

        def h2d_reps(k):
            times = []
            for _ in range(k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pinned.to("cuda", non_blocking=True)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return times

        h2d = h2d_reps(cfg["h2d_reps"])
        # the pipeline from the startup's weights; the packed path warmed
        # outside the timed window
        scope = scope_copy(init)
        del init
        train(tr, scope, hosts[:1])
        c0 = (staging._TRANSFERS.value, staging._WIRE_BYTES.value,
              staging._LEGACY_BYTES.value)
        losses = []
        made = len(rec.made)
        reset_launches()
        t0 = time.perf_counter()
        train(tr, scope, [hosts[i % len(hosts)] for i in range(steps)],
              lambda e: losses.append(e.cost)
              if isinstance(e, EndIteration) else None)
        float(losses[-1])
        pipeline_ms = (time.perf_counter() - t0) / steps * 1e3
        launches = read_launches()
        transfers = staging._TRANSFERS.value - c0[0]
        wire = staging._WIRE_BYTES.value - c0[1]
        legacy = staging._LEGACY_BYTES.value - c0[2]
        h2d += h2d_reps(cfg["h2d_reps"])
        h2d_ms = float(np.median(h2d))
        reader = rec.made[made]

        # where the copies ran: the profiler's trace of 3 more steps
        trace = os.path.join(ckpt, "pipeline_trace.json")
        act = torch.profiler.ProfilerActivity
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            # a profiler session after an earlier one records the card's
            # activity only from some milliseconds after its first op
            # (~6.5 ms on the H100 machine): ops first, so the staging
            # thread's copies, which come first, are recorded
            warm = torch.zeros(1, device="cuda")
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < PIPELINE_PROFILE_SETTLE_S:
                warm.add_(1)
                torch.cuda.synchronize()
            train(tr, scope, hosts)
            torch.cuda.synchronize()
        prof.export_chrome_trace(trace)
        copies, kernel_streams, h2d_events, busy = wire_copies(
            trace, wire_nbytes)
        stage_ms = float(np.median([(t1 - t0) * 1e3 for t0, t1 in
                                    reader["reader"].records]))
    finally:
        rec.close()
        config.set_flags(**prev)
        shutil.rmtree(ckpt, ignore_errors=True)
    bound = max(compute_ms, h2d_ms)
    print("[pipeline] ResNet-50 f32 fused, batch %d at %d, Trainer.train "
          "over %d steps on packed uint8/int32 feeds: pipeline %.3f ms a "
          "step (%.1f images/s), compute alone %.3f ms, pinned wire copy "
          "%.4f ms (median of %d, %.4f-%.4f ms), overlap max(compute, h2d) "
          "/ pipeline %.4f; wire %d bytes a batch against %d legacy (%.2fx "
          "cut), %d H2D copies (%g a batch); B1 %d launches (%g a step); "
          "losses %s"
          % (cfg["batch"], cfg["res"], steps, pipeline_ms,
             cfg["batch"] / pipeline_ms * 1e3, compute_ms, h2d_ms, len(h2d),
             min(h2d), max(h2d), bound / pipeline_ms, wire // steps,
             legacy // steps, legacy / max(wire, 1), transfers,
             transfers / steps, launches["conv_bn_stats"],
             launches["conv_bn_stats"] / steps,
             [round(float(v), 4) for v in losses]))
    print("[pipeline] staging: arena active %s, block pinned %s, staging "
          "thread %.3f ms a batch (median: reader pull, pack, copy); "
          "profiler over %d steps: %d copies of %d bytes host to device "
          "%s, kernels on streams %s, the card busy %.1f%% of the kernels' "
          "window" % (reader["arena_active"], reader["pinned"], stage_ms,
                      len(hosts), len(copies), wire_nbytes,
                      sorted(set(copies)), sorted(kernel_streams),
                      100 * busy))
    check(transfers == steps, "the packed path issued %d host-to-device "
          "copies over %d batches (want exactly 1 per batch)"
          % (transfers, steps))
    check(wire == steps * wire_nbytes, "wire bytes %d != %d batches x %d"
          % (wire, steps, wire_nbytes))
    check(reader["arena_active"] and reader["pinned"],
          "the staging arena is not active and pinned: %s"
          % {k: v for k, v in reader.items() if k != "reader"})
    check(len(copies) == len(hosts) and all(
        "Pinned" in name and stream not in kernel_streams
        for name, stream in copies),
        "the wire copies are not Pinned -> Device on a stream of their "
        "own: %s (kernels on %s; every host-to-device copy: %s)"
        % (copies, sorted(kernel_streams), h2d_events[:20]))
    check(launches["conv_bn_stats"] == B1_PER_STEP * steps,
          "B1 launches %d != %d x %d steps"
          % (launches["conv_bn_stats"], B1_PER_STEP, steps))
    check(all(v == 0 for k, v in launches.items() if k != "conv_bn_stats"),
          "the pipeline launched another kernel: %s" % launches)
    # random labels at lr 0.1 and batch 8 may diverge later in the pass;
    # the first step from the startup's weights may not
    check(np.isfinite(float(losses[0])), "non-finite first loss on the "
          "pipeline: %s" % [float(v) for v in losses])
    return dict(launches=launches["conv_bn_stats"], pipeline_ms=pipeline_ms,
                compute_ms=compute_ms, h2d_ms=h2d_ms, busy=busy)


def flash_inputs(b, h, t, d, lengths=None, dtype=None):
    """q, k, v [B, H, T, D] on the card (bfloat16 unless ``dtype``), and
    int32 segment ids [B, T] marking each row's first ``lengths[i]``
    positions live, or None."""
    import torch
    dtype = dtype or torch.bfloat16
    q, k, v = (torch.randn(b, h, t, d, device="cuda").to(dtype)
               for _ in range(3))
    seg = None
    if lengths is not None:
        lens = torch.tensor(lengths, device="cuda")
        seg = (torch.arange(t, device="cuda")[None] < lens[:, None]) \
            .to(torch.int32).contiguous()
    return q, k, v, seg


def bf16_err(got, want):
    """max |got - want| and one bf16 step of max |want|."""
    want = want.float()
    return float((got.float() - want).abs().max()), \
        BF16_STEP * float(want.abs().max())


def phase_compare_flash_bf16():
    """B2's bfloat16 instantiation (the path's tile) against its plain
    version on the card: the training shape, head dim 64, segment ids
    with padded rows, ragged T; two launches give the same bits."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    b, h, t, d = LM_ATTN
    worst = 0.0
    for label, shape, causal, lengths in (
            ("training shape", (b, h, t, d), True, None),
            ("head dim 64", (b, 2 * h, t, d // 2), True, None),
            ("segment ids", (2, h, t, d), True, [t, 300]),
            ("ragged T 100", (2, h, 100, d), True, None),
            ("ragged T 777, segment ids, not causal", (2, h, 777, d), False,
             [777, 500])):
        q, k, v, seg = flash_inputs(*shape, lengths)
        got = fa.flash_attention(q, k, v, causal, seg)
        again = fa.flash_attention(q, k, v, causal, seg)
        want = fa.flash_attention_plain(q, k, v, causal, seg)
        torch.cuda.synchronize()
        err, tol = bf16_err(got, want)
        print("[compare] flash_attention bf16 %s %s causal=%s: max_abs_err "
              "%.3g (tol one bf16 step %.3g); two launches bitwise equal %s"
              % (label, list(shape), causal, err, tol,
                 torch.equal(got, again)))
        check(got.dtype == torch.bfloat16 and err <= tol,
              "flash_attention bf16 disagrees at %s: %g" % (label, err))
        check(torch.equal(got, again),
              "flash_attention bf16: two launches differ at %s" % label)
        if lengths is not None:
            for i, n in enumerate(lengths):
                check(not got[i, :, n:].any(),
                      "flash_attention bf16 padded rows not 0")
        worst = max(worst, err)
        del q, k, v, got, again, want
    return worst


def phase_compare_flash_sweep():
    """T2: B2's bfloat16 forward at every tile of the sweep, against the
    plain version at the training shape (one bf16 step of max|out|), two
    launches bitwise equal, with its time. Every tile must launch."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, _ = flash_inputs(*LM_ATTN)
    want = fa.flash_attention_plain(q, k, v, True)
    out = {}
    for bq, bk in fa.SWEEP_TILES:
        kernel = functools.partial(fa.flash_attention_tile, q, k, v, bq, bk,
                                   True)
        got, again = uncounted(lambda: (kernel(), kernel()))
        torch.cuda.synchronize()
        err, tol = bf16_err(got, want)
        ms, profiler_ms = two_clocks(kernel)
        same = torch.equal(got, again)
        print("[compare] flash sweep %dx%d %s causal: max_abs_err %.3g (tol "
              "%.3g), two launches bitwise equal %s; %.4f ms between CUDA "
              "events over queued calls (profiler %.4f ms)"
              % (bq, bk, list(LM_ATTN), err, tol, same, ms, profiler_ms))
        check(err <= tol, "flash sweep %dx%d disagrees: %g" % (bq, bk, err))
        check(same, "flash sweep %dx%d: two launches differ" % (bq, bk))
        out[(bq, bk)] = dict(max_abs_err=err, ms=ms, profiler_ms=profiler_ms)
    path = fa.PATH_TILES[LM_ATTN[3]]
    best = min(out, key=lambda t: out[t]["ms"])
    print("[compare] flash sweep: fastest tile %dx%d (%.4f ms between CUDA "
          "events), the path's %dx%d (%.4f ms)"
          % (best + (out[best]["ms"],) + path + (out[path]["ms"],)))
    return out


def phase_compare_flash_backward():
    """The autograd Function's backward (the reference's chunked
    recompute, 2 chunks of 128 rows) on the card against autograd of the
    plain reference over the f32-upcast inputs, float32 and bfloat16, with
    segment ids and padded rows."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    b, h, t, d = 2, 4, 256, 128
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, seg = flash_inputs(b, h, t, d, [t, 150], dtype)
        g = torch.randn(b, h, t, d, device="cuda").to(dtype)
        qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
        out = fa.flash_attention(qa, ka, va, True, seg, block_q=128)
        out.backward(g)
        qr, kr, vr = (x.float().reshape(b * h, t, d).requires_grad_()
                      for x in (q, k, v))
        ref = fa._reference(qr, kr, vr, True, fa._bh_segments(seg, b, h, t))
        ref.backward(g.float().reshape(b * h, t, d))
        torch.cuda.synchronize()
        errs = []
        for name, got, want in (("dq", qa.grad, qr.grad), ("dk", ka.grad,
                                                            kr.grad),
                                ("dv", va.grad, vr.grad)):
            check(got.dtype == dtype, "%s dtype %s" % (name, got.dtype))
            want = want.reshape(b, h, t, d)
            errs.append(float((got.float() - want).abs().max()
                              / want.abs().max()))
        tol = FLASH_BWD_TOL[str(dtype).split(".")[1]]
        print("[compare] flash backward %s [%d, %d, %d, %d], segment ids, "
              "block_q 128: max_abs_err / max|grad| dq %.3g, dk %.3g, dv %.3g "
              "(tol %g)" % (dtype, b, h, t, d, *errs, tol))
        check(max(errs) <= tol, "flash backward disagrees in %s" % dtype)
        worst[dtype] = max(errs)
    return worst


def lm_named(model):
    """{reference name: numpy copy} of a model's parameters."""
    return {n: t.detach().cpu().numpy().copy()
            for n, t in model.reference_tensors().items()}


def phase_small_lm_train(rng):
    """A 2-layer LM (head dim 128, T 256) trained 3 Adam steps on the card
    (B2 forward, f32 or bf16) against the same LM on the CPU (plain
    versions), from the same weights and tokens, amp off and on."""
    import torch
    from paddle_tpu_torch import optimizer, trainer
    from paddle_tpu_torch.io import params_from_jax
    from paddle_tpu_torch.models.transformer import TransformerLM
    v, t, n = SMALL_LM_CFG["vocab_size"], SMALL_LM_T, SMALL_LM_BATCH
    ids = rng.integers(2, v, (n, t))
    named = None
    for amp in (None, "bfloat16"):
        runs = {}
        for dev in ("cpu", "cuda"):
            model = TransformerLM(max_len=t, device=dev, **SMALL_LM_CFG)
            if named is None:
                model.reset_parameters(0)
                named = lm_named(model)
            else:
                params_from_jax(named, model=model)
            opt = optimizer.Adam(model.reference_parameters(), SMALL_LM_LR)
            toks = torch.from_numpy(ids).to(dev)
            reset_launches()
            with amp_flag(amp):
                losses = [float(trainer.train_step(model, opt, toks,
                                                   toks)[0])
                          for _ in range(SMALL_LM_STEPS)]
            launches = read_launches()
            runs[dev] = (losses, lm_named(model), launches, opt.accumulators())
        (cpu_l, cpu_p, _, _), (card_l, card_p, launches, accs) = \
            runs["cpu"], runs["cuda"]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
        near, share = SMALL_LM_NEAR[amp]
        worst_far, worst_share = 0.0, 1.0
        for name, want in cpu_p.items():
            diff = np.abs(card_p[name].astype(np.float64) - want)
            worst_far = max(worst_far, float(diff.max()))
            worst_share = min(worst_share,
                              float(np.mean(diff <= near * SMALL_LM_LR)))
        layers = SMALL_LM_CFG["num_layers"]
        bf16 = launches["flash_attention bf16"]
        print("[small-lm-train] amp %s, 3 Adam steps: losses card %s cpu %s "
              "(rel err %.3g, tol %g); parameters card vs CPU: max %.3g lr "
              "(tol %d lr), smallest share of a tensor within %g lr %.4f "
              "(tol %g); B2 launches on the card %d (%d bf16)"
              % (amp, [round(x, 6) for x in card_l],
                 [round(x, 6) for x in cpu_l], loss_err,
                 SMALL_LM_LOSS_RTOL[amp], worst_far / SMALL_LM_LR,
                 2 * SMALL_LM_STEPS, near, worst_share, share,
                 launches["flash_attention"], bf16))
        check(loss_err <= SMALL_LM_LOSS_RTOL[amp],
              "small LM losses on the card disagree with the CPU (amp %s)"
              % amp)
        check(worst_far <= 2 * SMALL_LM_STEPS * SMALL_LM_LR
              and worst_share >= share,
              "small LM parameters on the card disagree with the CPU "
              "(amp %s)" % amp)
        check(np.isfinite(card_l).all() and card_l[-1] < card_l[0],
              "the small LM did not train (amp %s): %s" % (amp, card_l))
        check(launches["flash_attention"] == layers * SMALL_LM_STEPS
              and bf16 == (launches["flash_attention"] if amp else 0),
              "small LM B2 launches %s" % launches)
        check(all(a.dtype == torch.float32 for a in accs.values()),
              "an accumulator is not float32")


def phase_lm_train(seed, rng):
    """The flagship LM's training step at bench.py's accelerator
    configuration (run under the ``amp`` flag, which the caller sets and
    the model reads at each step): warm-up steps, then LM_WINDOWS windows of
    LM_WINDOW_STEPS steps, each closed by a synchronize, every launch
    count at 0 just before the windows. Returns (model, optimizer,
    tokens, launches, stats)."""
    import torch
    from paddle_tpu_torch import config, optimizer, trainer
    from paddle_tpu_torch.models.transformer import TransformerLM
    check(config.get_flag("amp") == "bfloat16", "[lm-train] needs amp on")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = {k: v for k, v in FULL.items() if k != "max_len"}
    t0 = time.perf_counter()
    model = TransformerLM(max_len=LM_TRAIN["seqlen"], device="cuda", **cfg)
    model.reset_parameters(seed)
    opt = optimizer.Adam(model.reference_parameters(), LM_TRAIN["lr"])
    b, t = LM_TRAIN["batch"], LM_TRAIN["seqlen"]
    tokens = torch.from_numpy(rng.integers(2, FULL["vocab_size"],
                                           (b, t))).cuda()
    nparam = sum(p.numel() for p in model.reference_parameters().values())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    losses = []
    t0 = time.perf_counter()
    for _ in range(LM_WARMUP):
        losses.append(float(trainer.train_step(model, opt, tokens,
                                               tokens)[0]))
    warm_s = time.perf_counter() - t0
    reset_launches()
    window_ms = []
    for _ in range(LM_WINDOWS):
        t0 = time.perf_counter()
        for _ in range(LM_WINDOW_STEPS):
            loss, _ = trainer.train_step(model, opt, tokens, tokens)
        losses.append(float(loss))          # the read closes the window
        window_ms.append((time.perf_counter() - t0) * 1e3 / LM_WINDOW_STEPS)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    steps = LM_WINDOWS * LM_WINDOW_STEPS
    med = sorted(window_ms)[len(window_ms) // 2]
    tok_s = b * t / med * 1e3
    fpt = 6.0 * nparam + 6.0 * FULL["num_layers"] * t * FULL["d_model"]
    mfu = tok_s * fpt / BF16_FLOPS
    print("[lm-train] transformer LM, vocab %d, d_model %d, %d heads, d_ff "
          "%d, %d layers, batch %d x T %d, amp bfloat16, Adam(%g): %d "
          "parameters (%.2f GB f32); built on the card in %.2f s; %d "
          "warm-up steps %.2f s" % (FULL["vocab_size"], FULL["d_model"],
                                    FULL["num_heads"], FULL["d_ff"],
                                    FULL["num_layers"], b, t,
                                    LM_TRAIN["lr"], nparam, nparam * 4 / 1e9,
                                    build_s, LM_WARMUP, warm_s))
    print("[lm-train] %d windows of %d steps: median %.2f ms a step, %.1f "
          "tokens/s, MFU %.4f of %.0f TFLOP/s bf16 (%.4g FLOP a token = 6N + "
          "6LTd, %.2f TFLOP a step); windows ms %s"
          % (LM_WINDOWS, LM_WINDOW_STEPS, med, tok_s, mfu, BF16_FLOPS / 1e12,
             fpt, fpt * b * t / 1e12, [round(w, 2) for w in window_ms]))
    print("[lm-train] losses (warm-up, then each window's last) %s; peak "
          "memory allocated %.2f GB; launches in the windows %s (%d bf16 B2 "
          "a step)" % ([round(x, 4) for x in losses], peak / 1e9, launches,
                       launches["flash_attention bf16"] // steps))
    per_step = FULL["num_layers"] * steps
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          "the LM's losses do not fall: %s" % losses)
    check(launches["flash_attention bf16"] == per_step
          and launches["flash_attention"] == per_step,
          "B2 bf16 launches %d != %d layers x %d steps"
          % (launches["flash_attention bf16"], FULL["num_layers"], steps))
    check(all(v == 0 for k, v in launches.items()
              if not k.startswith("flash_attention")) and
          launches["flash_attention_tile"] == 0,
          "the LM training path launched another kernel: %s" % launches)
    stats = dict(step_ms=med, tokens_per_s=tok_s, mfu=mfu, peak_bytes=peak,
                 n_params=nparam)
    return model, opt, tokens, launches, stats


def phase_profile_lm_train(model, opt, tokens):
    """One LM training step under the profiler; B2's share."""
    from paddle_tpu_torch import trainer
    profile_step("LM training step",
                 lambda: trainer.train_step(model, opt, tokens, tokens),
                 "B2 bf16", ("flash_fwd_bf16_kernel",), top=12)


def lm_program(cfg, t, lr=None, dropout_prob=0.0, is_test=False):
    """(main, startup, loss name, logits name) of the transformer LM as
    bench.py builds it, through the port's front end: ``transformer_lm``
    given Variables and, with ``lr``, ``Adam(lr).minimize``."""
    from paddle_tpu_torch import core, layers, optimizer
    from paddle_tpu_torch.models import transformer
    main, startup = core.Program(), core.Program()
    with core.unique_name.guard(), core.program_guard(main, startup):
        toks = layers.data("toks", shape=[t], dtype="int64")
        lbls = layers.data("lbls", shape=[t], dtype="int64")
        loss, logits = transformer.transformer_lm(
            toks, lbls, dropout_prob=dropout_prob, is_test=is_test, **cfg)
        if lr is not None:
            optimizer.Adam(lr).minimize(loss, startup)
    return main, startup, loss.name, logits.name


def lm_feed(batch, t, vocab, device):
    """bench.py's LM feed: one RandomState(0).randint(2, vocab) draw for
    tokens and labels, int32, put on ``device`` once."""
    import torch
    ids = np.random.RandomState(0).randint(2, vocab, (batch, t))
    ids = torch.from_numpy(ids.astype(np.int32)).to(device)
    return {"toks": ids, "lbls": ids}


def phase_small_program_lm(seed):
    """The LM program at a small width (SMALL_PROGRAM_LM), serialized to
    JSON and loaded, run from one set of startup weights on the card and
    on the CPU for SMALL_LM_STEPS Adam steps, amp off and on; and with
    dropout 0.1, whose first step's masks must be torch.equal card to
    CPU (both executors split one key)."""
    import torch
    from paddle_tpu_torch import core
    from paddle_tpu_torch.core import serialization
    cfg, t, b = SMALL_PROGRAM_LM, SMALL_PROGRAM_LM_T, SMALL_PROGRAM_LM_BATCH
    lr, steps = SMALL_LM_LR, SMALL_LM_STEPS
    for dropout, amps in ((0.0, (None, "bfloat16")), (0.1, (None,))):
        main, startup, loss, _ = lm_program(cfg, t, lr, dropout_prob=dropout)
        text = json.dumps(serialization.program_to_dict(main))
        main = serialization.program_from_dict(json.loads(text))
        startup.random_seed = seed
        init = core.Scope()
        core.Executor(device="cpu").run(startup, scope=init)
        masks = [op.outputs["Mask"][0] for op in main.global_block().ops
                 if op.type == "dropout"]
        params = [p.name for p in main.all_parameters()]
        for amp in amps:
            runs = {}
            for dev in ("cpu", "cuda"):
                scope = scope_copy(init, dev)
                exe = core.Executor(device=dev)
                feed = lm_feed(b, t, cfg["vocab_size"], dev)
                losses, first = [], []
                reset_launches()
                with amp_flag(amp):
                    for i in range(steps):
                        outs = exe.run(main, feed=feed, scope=scope,
                                       fetch_list=[loss] + (
                                           masks if i == 0 else []),
                                       return_numpy=False)
                        losses.append(float(outs[0]))
                        first += [m.cpu() for m in outs[1:]]
                runs[dev] = (losses, {n: scope.find_var(n).cpu()
                                      for n in params}, first,
                             read_launches())
            (cpu_l, cpu_p, cpu_m, _), (card_l, card_p, card_m, launches) = \
                runs["cpu"], runs["cuda"]
            loss_err = max(abs(x - y) / abs(y) for x, y in zip(card_l, cpu_l))
            far = max(float((card_p[n] - cpu_p[n]).abs().max())
                      for n in params)
            equal = sum(torch.equal(x, y) for x, y in zip(card_m, cpu_m))
            print("[small-program-lm] LM program (%d KB of JSON, %d ops), "
                  "width %d, %d layers, T %d, dropout %g, amp %s, %d Adam "
                  "steps: losses card %s cpu %s (rel err %.3g, tol %g); "
                  "parameters card vs CPU max %.3g lr (tol %d lr); dropout "
                  "masks torch.equal card to CPU %d of %d; B2 launches on "
                  "the card %d (%d bf16)"
                  % (len(text) // 1024, len(main.global_block().ops),
                     cfg["d_model"], cfg["num_layers"], t, dropout, amp,
                     steps, [round(x, 6) for x in card_l],
                     [round(x, 6) for x in cpu_l], loss_err,
                     SMALL_LM_LOSS_RTOL[amp], far / lr, 2 * steps,
                     equal, len(masks), launches["flash_attention"],
                     launches["flash_attention bf16"]))
            check(loss_err <= SMALL_LM_LOSS_RTOL[amp]
                  and far <= 2 * steps * lr,
                  "the small LM program on the card disagrees with the CPU "
                  "(dropout %g, amp %s)" % (dropout, amp))
            check(equal == len(masks) == len(cpu_m)
                  == 2 * cfg["num_layers"] * (dropout > 0),
                  "dropout masks differ card to CPU")
            check(np.isfinite(card_l).all() and card_l[-1] < card_l[0],
                  "the small LM program did not train: %s" % card_l)
            per_run = cfg["num_layers"] * steps
            check(launches["flash_attention"] == per_run and
                  launches["flash_attention bf16"] == (per_run if amp else 0)
                  and all(v == 0 for k, v in launches.items()
                          if not k.startswith("flash_attention")
                          or k == "flash_attention_tile"),
                  "small LM program launches %s" % launches)


def phase_small_program_int8(seed):
    """[small-program], armed: the ResNet-8 forward program (is_test)
    armed for int8 compute by ``arm_quant_compute([program], scope)`` on
    the card and on the CPU from one set of startup weights. Each int8
    conv2d of the card, given the CPU run's input, must be torch.equal
    to the CPU's output (the integer convolution is exact on both), and
    so must the fc's armed product, B3 on the card, given the CPU run's
    fc input (B3 is bitwise its plain version). The logits are held to a
    quarter of the int8 forward's own distance from the float32 forward
    (CPU): an f32 op before a convolution (the batch norm's rsqrt, the
    pooling's sums) rounds an ulp apart on the card now and then, and
    where that moves a sample's amax or crosses a rounding boundary an
    int8 code moves by a quantization step, far more than
    SMALL_RESNET_RTOL (0.00215 of the logits' norm on an NVIDIA H100
    80GB HBM3 at 700 W)."""
    import torch
    from paddle_tpu_torch import core, layers
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.ops import quant_ops
    from paddle_tpu_torch.serving.quant import arm_quant_compute
    cfg = SMALL_PROGRAM
    main, startup = core.Program(), core.Program()
    with core.unique_name.guard(), core.program_guard(main, startup):
        img = layers.data("img", shape=[3, cfg["res"], cfg["res"]])
        label = layers.data("label", shape=[1], dtype="int64")
        logits = resnet.resnet_cifar10(img, label, depth=cfg["depth"],
                                       is_test=True)[2].name
    startup.random_seed = seed
    init = core.Scope()
    core.Executor(device="cpu").run(startup, scope=init)
    convs = [op for op in main.global_block().ops if op.type == "conv2d"]
    fcs = [op for op in main.global_block().ops if op.type == "mul"]
    names = [logits] + [n for op in convs
                        for n in (op.inputs["Input"][0],
                                  op.outputs["Output"][0])] \
        + [n for op in fcs for n in (op.inputs["X"][0], op.outputs["Out"][0])]
    f32 = core.Executor(device="cpu").run(
        main, feed=bench_feed(cfg["batch"], cfg["res"], 10, "cpu"),
        scope=scope_copy(init, "cpu"), fetch_list=[logits],
        return_numpy=False)[0]
    runs = {}
    for dev in ("cpu", "cuda"):
        scope = scope_copy(init, dev)
        armed = arm_quant_compute([main], scope)
        feed = bench_feed(cfg["batch"], cfg["res"], 10, dev)
        reset_launches()
        outs = core.Executor(device=dev).run(main, feed=feed, scope=scope,
                                             fetch_list=names,
                                             return_numpy=False)
        runs[dev] = (armed, dict(zip(names, outs)), read_launches(), scope)
    (armed, cpu, _, _), (card_armed, card, launches, scope) = \
        runs["cpu"], runs["cuda"]
    same = 0
    for op in convs:
        got = quant_ops.quant_conv2d(
            cpu[op.inputs["Input"][0]].cuda(),
            scope.find_var(op.inputs["Filter"][0]),
            scope.find_var(quant_ops.scale_var_name(op.inputs["Filter"][0])),
            op.attrs["strides"], op.attrs["paddings"], op.attrs["dilations"],
            op.attrs["groups"]).cpu()
        same += torch.equal(got, cpu[op.outputs["Output"][0]])
    fc_same = 0
    for op in fcs:
        w = op.inputs["Y"][0]
        got = uncounted(lambda: quant_ops._quant_mul(
            op, cpu[op.inputs["X"][0]].cuda(), scope.find_var(w),
            scope.find_var(quant_ops.scale_var_name(w)))["Out"]).cpu()
        fc_same += torch.equal(got, cpu[op.outputs["Out"][0]])
    in_run = sum(torch.equal(card[op.outputs["Output"][0]].cpu(),
                             cpu[op.outputs["Output"][0]]) for op in convs)
    err = rel_dist(card[logits].cpu(), cpu[logits])
    quant_err = rel_dist(cpu[logits], f32)
    print("[small-program] ResNet-8 forward armed int8 (%d names: %d conv2d "
          "filters and the fc): each int8 conv2d on the card from the CPU "
          "run's input torch.equal to the CPU's output %d of %d (in the "
          "card's own run %d of %d); the fc's armed product through B3 from the CPU "
          "run's input torch.equal to the CPU's %d of %d; B3 launches %d; "
          "logits card vs CPU rel err %.3g (tol %.3g: a quarter of int8 vs "
          "float32 on the CPU, %.3g)"
          % (len(armed), len(convs), same, len(convs), in_run, len(convs),
             fc_same, len(fcs), launches["int8_matmul"], err,
             quant_err / 4, quant_err))
    check(armed == card_armed and len(armed) == len(convs) + 1,
          "armed names %s / %s" % (armed, card_armed))
    check(same == len(convs), "an int8 conv2d differs card to CPU")
    check(len(fcs) == 1 and fc_same == 1,
          "the fc's armed product differs card to CPU")
    check(launches["int8_matmul"] == 1 and all(
        v == 0 for k, v in launches.items() if k != "int8_matmul"),
          "the armed ResNet-8 launched %s" % launches)
    check(err <= quant_err / 4, "armed ResNet-8 logits card vs CPU")


def phase_program_lm_train(seed, module_stats):
    """The flagship LM through the program path as bench.py's
    bench_transformer_lm runs it (LM_TRAIN's configuration, amp
    bfloat16, Adam(1e-4).minimize, Executor.run): one step from the
    startup program's weights against the nn.Module route from the same
    weights, then warm-up and LM_WINDOWS windows of LM_WINDOW_STEPS
    Executor.run calls, each closed by reading the loss, every launch
    count at 0 just before the windows; the median window beside
    [lm-train]'s nn.Module step of this run."""
    import torch
    from paddle_tpu_torch import core, optimizer, trainer
    from paddle_tpu_torch.models.transformer import TransformerLM
    torch.cuda.empty_cache()
    cfg = {k: v for k, v in FULL.items() if k != "max_len"}
    b, t, lr = LM_TRAIN["batch"], LM_TRAIN["seqlen"], LM_TRAIN["lr"]
    t0 = time.perf_counter()
    main, startup, loss, _ = lm_program(cfg, t, lr)
    build_s = time.perf_counter() - t0
    startup.random_seed = seed
    exe, scope = core.Executor(device="cuda"), core.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    feed = lm_feed(b, t, cfg["vocab_size"], "cuda")
    nparam = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    # one step of the nn.Module route from the startup weights
    model = TransformerLM(max_len=t, device="cuda", **cfg)
    with torch.no_grad():
        for n, p in model.reference_tensors().items():
            p.copy_(scope.find_var(n))
    opt = optimizer.Adam(model.reference_parameters(), lr)
    with amp_flag("bfloat16"):
        mod_loss = float(trainer.train_step(model, opt, feed["toks"],
                                            feed["lbls"])[0])
        accs = opt.accumulators()
        del opt
        for p in model.parameters():
            p.grad = None
        t0 = time.perf_counter()
        first = float(exe.run(main, feed=feed, fetch_list=[loss],
                              scope=scope, return_numpy=False)[0])
        first_s = time.perf_counter() - t0
    loss_err = abs(first - mod_loss) / abs(mod_loss)
    # Adam's first step moves an element by at most lr, so the routes
    # part by at most 2 lr, plus the rounding of each updated value
    # (an ulp of the tensor's largest magnitude each)
    far = 0.0
    for n, p in model.reference_tensors().items():
        p = p.detach()
        ulp = float(np.spacing(np.float32(float(p.abs().max()))))
        far = max(far, float((scope.find_var(n) - p).abs().max()) - 2 * ulp)
    # that bound holds whatever the gradients; the moments hold them:
    # after one step the first is (1 - beta1) g and the second (1 -
    # beta2) g^2, each leaf's largest difference over its largest
    # magnitude within PROGRAM_LM_GRAD_RTOL (the second, squared, twice)
    moment_err = {"moment1": 0.0, "moment2": 0.0}
    bitwise = 0
    for n, a in accs.items():
        kind = n.rsplit("_", 3)[-3]
        if kind not in moment_err:
            continue
        got = scope.find_var(n)
        bitwise += torch.equal(got, a)
        moment_err[kind] = max(moment_err[kind], float(
            (got - a).abs().max()) / max(float(a.abs().max()), 1e-30))
    del model, accs
    gc.collect()
    torch.cuda.empty_cache()
    counts = dict(collections.Counter(
        op.type for op in main.global_block().ops).most_common())
    print("[program-lm-train] LM program as bench.py builds it: %d ops %s; "
          "%d parameters; built in %.2f s, startup on the card %.2f s (seed "
          "%d), first step %.2f s" % (len(main.global_block().ops), counts,
                                      nparam, build_s, init_s, seed,
                                      first_s))
    print("[program-lm-train] one step from the startup weights: loss "
          "executor %.6f, nn.Module %.6f (rel err %.3g, tol %g); parameters "
          "max %.4f lr apart, less two roundings (tol 2 lr); Adam moments "
          "worst leaf rel err %s (tol %g, moment2 %g), %d of %d moments "
          "bitwise" % (first, mod_loss, loss_err, PROGRAM_LM_LOSS_RTOL,
                       far / lr, moment_err, PROGRAM_LM_GRAD_RTOL,
                       2 * PROGRAM_LM_GRAD_RTOL, bitwise,
                       2 * len(main.all_parameters())))
    check(loss_err <= PROGRAM_LM_LOSS_RTOL and far <= 2 * lr,
          "the LM program and the nn.Module route disagree on one step")
    check(moment_err["moment1"] <= PROGRAM_LM_GRAD_RTOL and
          moment_err["moment2"] <= 2 * PROGRAM_LM_GRAD_RTOL,
          "the LM program's gradients differ from the nn.Module route's: "
          "%s" % moment_err)
    torch.cuda.reset_peak_memory_stats()
    losses = [first]
    with amp_flag("bfloat16"):
        for _ in range(LM_WARMUP - 1):
            outs = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                           return_numpy=False)
            losses.append(float(outs[0]))
        reset_launches()
        window_ms = []
        for _ in range(LM_WINDOWS):
            t0 = time.perf_counter()
            for _ in range(LM_WINDOW_STEPS):
                outs = exe.run(main, feed=feed, fetch_list=[loss],
                               scope=scope, return_numpy=False)
            losses.append(float(outs[0]))     # the read closes the window
            window_ms.append((time.perf_counter() - t0) * 1e3
                             / LM_WINDOW_STEPS)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    steps = LM_WINDOWS * LM_WINDOW_STEPS
    med = sorted(window_ms)[len(window_ms) // 2]
    tok_s = b * t / med * 1e3
    fpt = 6.0 * nparam + 6.0 * FULL["num_layers"] * t * FULL["d_model"]
    mfu = tok_s * fpt / BF16_FLOPS
    print("[program-lm-train] amp bfloat16, batch %d x T %d, Adam(%g): %d "
          "windows of %d Executor.run: median %.2f ms a step, %.1f tokens/s, "
          "MFU %.4f of %.0f TFLOP/s bf16 (%.4g FLOP a token = 6N + 6LTd); "
          "beside [lm-train]'s nn.Module step %.2f ms of this run: the "
          "executor costs %.2f ms a step; windows ms %s"
          % (b, t, lr, LM_WINDOWS, LM_WINDOW_STEPS, med, tok_s, mfu,
             BF16_FLOPS / 1e12, fpt, module_stats["step_ms"],
             med - module_stats["step_ms"], [round(w, 2) for w in window_ms]))
    print("[program-lm-train] peak memory allocated %.2f GB ([lm-train] %.2f "
          "GB, %+.1f%%); losses (warm-up, then each window's last) %s; "
          "launches in the windows %s (%d bf16 B2 a step)"
          % (peak / 1e9, module_stats["peak_bytes"] / 1e9,
             100 * (peak / module_stats["peak_bytes"] - 1),
             [round(x, 4) for x in losses],
             {k: v for k, v in launches.items() if v},
             launches["flash_attention bf16"] // steps))
    per_step = FULL["num_layers"] * steps
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          "the LM program's losses do not fall: %s" % losses)
    check(launches["flash_attention bf16"] == per_step
          and launches["flash_attention"] == per_step,
          "B2 bf16 launches %d != %d layers x %d steps"
          % (launches["flash_attention bf16"], FULL["num_layers"], steps))
    check(all(v == 0 for k, v in launches.items()
              if not k.startswith("flash_attention")) and
          launches["flash_attention_tile"] == 0,
          "the LM program launched another kernel: %s" % launches)
    check(abs(peak / module_stats["peak_bytes"] - 1) <= PROGRAM_LM_PEAK,
          "the LM program's peak memory %.2f GB is not within %d%% of "
          "[lm-train]'s %.2f GB" % (peak / 1e9, 100 * PROGRAM_LM_PEAK,
                                    module_stats["peak_bytes"] / 1e9))
    with amp_flag("bfloat16"):
        profile_step("[program-lm-train] one Executor.run",
                     lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                     scope=scope, return_numpy=False),
                     "B2 bf16", ("flash_fwd_bf16_kernel",), top=12)
    del scope
    return dict(step_ms=med, tokens_per_s=tok_s, mfu=mfu, peak_bytes=peak,
                launches=launches)


def phase_program_lm_int8(seed):
    """The LM's forward program (is_test) at FULL's widths, batch 1 x T
    PROGRAM_INT8_T, from its startup program's weights on the card, run
    float32, then armed by ``arm_quant_compute([program], scope)``: the
    73 armed names are lm_mul_weight_names(12), B3 launches 73 a run, and
    the logits equal the nn.Module int8 route's on the same int8 weights
    and tokens within LM_INT8_STEPS head quantization steps. Returns B3's
    launches in one armed run by (m, k, n), as its wrapper counted them:
    4 a layer at (T, d, d), 1 at (T, d, d_ff) and at (T, d_ff, d), and
    the head at (T, d, vocab)."""
    import torch
    from paddle_tpu_torch import core
    from paddle_tpu_torch.io import params_from_jax
    from paddle_tpu_torch.models.transformer import (TransformerLM,
                                                     lm_mul_weight_names)
    from paddle_tpu_torch.serving.quant import arm_quant_compute
    torch.cuda.empty_cache()
    cfg = {k: v for k, v in FULL.items() if k != "max_len"}
    t = PROGRAM_INT8_T
    main, startup, _, logits = lm_program(cfg, t, is_test=True)
    startup.random_seed = seed
    exe, scope = core.Executor(device="cuda"), core.Scope()
    exe.run(startup, scope=scope)
    feed = lm_feed(1, t, cfg["vocab_size"], "cuda")

    def timed():
        ms = []
        for _ in range(PROGRAM_INT8_RUNS):
            t0 = time.perf_counter()
            out = exe.run(main, feed=feed, fetch_list=[logits], scope=scope,
                          return_numpy=False)[0]
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return sorted(ms)[len(ms) // 2], out

    uncounted(lambda: exe.run(main, feed=feed, fetch_list=[logits],
                              scope=scope))
    f32_ms, _ = uncounted(timed)
    t0 = time.perf_counter()
    armed = arm_quant_compute([main], scope)
    arm_s = time.perf_counter() - t0
    want = sorted(lm_mul_weight_names(cfg["num_layers"]))
    reset_launches()
    out = exe.run(main, feed=feed, fetch_list=[logits], scope=scope,
                  return_numpy=False)[0]
    launches = read_launches()
    by_shape = read_int8_shapes()
    int8_ms, _ = uncounted(timed)
    model = TransformerLM(max_len=t, device="cuda", **cfg)
    model.load_params(params_from_jax(
        {n: v.cpu().numpy() for n, v in scope.items()}, device="cuda"))
    with torch.no_grad():
        mod = uncounted(lambda: model(feed["toks"].long()))
    amax = (cfg["d_model"] - 1) ** 0.5 * float(model.ln_f_w.abs().max()) \
        + float(model.ln_f_b.abs().max())
    tol = LM_INT8_STEPS * amax * float(model.lm_head_scale.max())
    diff = float((out - mod).abs().max())
    print("[program-lm-int8] LM forward program, batch 1 x T %d, armed by "
          "arm_quant_compute([program], scope) in %.2f s: %d names (the "
          "nn.Module route's lm_mul_weight_names: %s); one armed run launched "
          "%s, B3 by (m, k, n) %s; median of %d runs %.2f ms armed, %.2f "
          "ms float32; logits "
          "against the nn.Module int8 route on the same int8 weights: max "
          "abs diff %.3g (tol %.3g = %d head quantization steps), bitwise "
          "%s" % (t, arm_s, len(armed), armed == want,
                  {k: v for k, v in launches.items() if v}, by_shape,
                  PROGRAM_INT8_RUNS, int8_ms, f32_ms, diff, tol,
                  LM_INT8_STEPS, torch.equal(out, mod)))
    per_run = len(want)
    check(armed == want and len(armed) == 6 * cfg["num_layers"] + 1,
          "armed names differ from lm_mul_weight_names")
    d, f, L = cfg["d_model"], cfg["d_ff"], cfg["num_layers"]
    want_shapes = {(t, d, d): 4 * L, (t, d, f): L, (t, f, d): L,
                   (t, d, cfg["vocab_size"]): 1}
    check(launches["int8_matmul"] == per_run,
          "B3 launches %d != %d a run" % (launches["int8_matmul"], per_run))
    check(by_shape == want_shapes,
          "B3 launches by shape %s != %s" % (by_shape, want_shapes))
    check(launches["flash_attention"] == cfg["num_layers"] and
          all(v == 0 for k, v in launches.items()
              if k not in ("int8_matmul", "flash_attention")),
          "the armed program launched %s" % launches)
    check(diff <= tol and bool(torch.isfinite(out).all()),
          "armed program logits vs the nn.Module int8 route")
    del model, scope
    return by_shape


def phase_small_program_serve(seed):
    """[small-program-serve]: SMALL_SERVE served through its generation
    programs (``GenerationSession(spec, scope)``) on the card and on the
    CPU, each configuration of SMALL_SERVE_KW's cells; the tokens must be
    equal card to CPU. Prints the card's kernel launches."""
    from paddle_tpu_torch.io import scope_from_jax
    from paddle_tpu_torch.models.transformer import transformer_lm_session
    from paddle_tpu_torch.serving import GenerationSession
    from paddle_tpu_torch.serving.decoding import DecodePolicy
    rng = np.random.default_rng(seed + 9)
    named = {n: rng.standard_normal(v.shape, dtype=np.float32)
             for n, v in make_params(SMALL_SERVE, rng).items()}
    paged = dict(paged=True, prefix_cache=True)
    cells = (("greedy dense", dict(paged=False), None, (0,)),
             ("greedy paged", paged, None, (0,)),
             ("sampled dense", dict(paged=False),
              DecodePolicy("sample", **SAMPLE_KNOBS), SAMPLE_SEEDS[:2]),
             ("speculative paged", paged, DecodePolicy(
                 speculate_k=3,
                 draft=dict(num_layers=SMALL_SERVE["num_layers"])), (0,)))
    reset_launches()
    for label, kw, policy, seeds in cells:
        outs, stats = {}, {}
        for dev in ("cpu", "cuda"):
            spec = transformer_lm_session(
                device=dev, decode_policy=policy,
                **dict(SMALL_SERVE, **SMALL_SERVE_KW, **kw))
            sess = GenerationSession(spec, scope_from_jax(named, device=dev))
            outs[dev] = [sess.generate(p, max_new_tokens=SMALL_SERVE_NEW,
                                       eos_id=-1, seed=sd)
                         for p in SMALL_SERVE_PROMPTS for sd in seeds]
            stats[dev] = (sess.compile_stats(), sess.prefix_stats()["hits"],
                          sess.spec_accepted)
            sess.close()
        same = sum(a == b for a, b in zip(outs["cuda"], outs["cpu"]))
        print("[small-program-serve] %s: %d streams of %d tokens, equal "
              "card to CPU %d; card compile stats %s, prefix hits %d, "
              "accepted drafts %d" % (label, len(outs["cuda"]),
                                      SMALL_SERVE_NEW, same,
                                      *stats["cuda"]))
        check(same == len(outs["cpu"]),
              "small program serve (%s): tokens differ card to CPU" % label)
        check(stats["cuda"] == stats["cpu"],
              "small program serve (%s): stats %s on the card, %s on the "
              "CPU" % (label, stats["cuda"], stats["cpu"]))
    launches = read_launches()
    print("[small-program-serve] launches on the card: %s" % launches)
    check(all(launches[k] > 0 for k in ("flash_attention",
                                        "decode_attention",
                                        "decode_attention_paged")),
          "small program serve launches %s" % launches)


def program_scope(session):
    """A Scope holding ``session``'s model tensors under their reference
    names by reference, no copy (an armed model's int8 weights with their
    scales): the program route on the module route's weights."""
    from paddle_tpu_torch import core
    scope = core.Scope()
    for name, t in session.model.reference_state().items():
        scope.set_var(name, t)
    return scope


def program_streams(tag, outs, base, prompts, gap_sess):
    """The program route's streams against the module route's on the same
    prompts: equal, or first differing at a near-tie (``near_tie_rule``;
    the two routes compute a prefill's LM head over other row counts, the
    reference's program over every window row)."""
    same = near_tie_rule(tag, base, outs, prompts, gap_sess)
    print("[%s] streams equal to the nn.Module route's: %d of %d"
          % (tag, same, len(prompts)))


def phase_program_serve(sess, paged, quant, dense_prompts, dense_outs,
                        prompts, paged_outs, quant_outs, paged_peak, rng):
    """[program-serve]: the flagship LM served through the generation
    programs on the module sessions' weights by reference: the dense
    cell's requests, the paged cell's five (f32, and int8 weights with
    bfloat16 pools) and a speculative paged session (the verify
    program), each with every launch count at 0 just before. Tokens
    against the module route's; B2 (12 a dense admission), B4 (12 a dense
    step), B5 (12 a paged step and a verify) and B3 (73 an armed
    admission and step) under program ops; the paged cell's peak beside
    the module cell's; TTFT per bucket and the decode step at 8 slots in
    turns with the module route; one profiled decode step of each.
    Returns the launch counts for the kernels line."""
    import torch
    from paddle_tpu_torch.models.transformer import transformer_lm_session
    from paddle_tpu_torch.serving import (GenerationScheduler,
                                          GenerationSession)
    from paddle_tpu_torch.serving.decoding import DecodePolicy
    layers, v = FULL["num_layers"], FULL["vocab_size"]
    dense_kw = dict(slots=SLOTS, cache_len=CACHE_LEN, prompt_buckets=BUCKETS,
                    eos_id=1, device="cuda", decode_policy=None, **FULL)
    paged_kw = dict(dense_kw, paged=True, block_size=BLOCK_SIZE,
                    num_blocks=0, prefix_cache=True)
    t0 = time.perf_counter()
    specs = {"dense": transformer_lm_session(**dense_kw),
             "paged": transformer_lm_session(**paged_kw),
             "int8": transformer_lm_session(dtype="bfloat16", **paged_kw)}
    build_s = time.perf_counter() - t0
    pdense = GenerationSession(specs["dense"], program_scope(sess))
    ppaged = GenerationSession(specs["paged"], program_scope(paged))
    pquant = GenerationSession(specs["int8"], program_scope(quant),
                               arm_quant=True)
    ops = {k: len(sp.decode_program.global_block().ops)
           for k, sp in specs.items()}
    print("[program-serve] three specs built in %.2f s (decode program "
          "ops: %s; prefill 512: %d ops); the int8 one armed %d weights "
          "of the module session's int8 tensors"
          % (build_s, ops, len(specs["dense"].prefill_programs[
              BUCKETS[-1]].global_block().ops), len(pquant._quant_armed)))
    check(pquant._quant_armed == sorted(quant._quant_armed)
          and len(pquant._quant_armed) == INT8_PER_PASS,
          "the program session armed %s" % pquant._quant_armed)
    out = {}

    # the dense cell: the dense phase's requests through the scheduler
    sched = GenerationScheduler(pdense, autostart=False)
    reset_launches()
    pre0, st0 = pdense.prefills, pdense.steps
    t0 = time.perf_counter()
    futs = [sched.submit(p, max_new_tokens=NEW_TOKENS, eos_id=-1)
            for p in dense_prompts]
    sched.start()
    outs = [f.result(timeout=600) for f in futs]
    sched.drain(timeout=60)
    torch.cuda.synchronize()
    launches = read_launches()
    adm, steps = pdense.prefills - pre0, pdense.steps - st0
    print("[program-serve] dense: %d requests, %d admissions, %d decode "
          "steps in %.2f s; launches %s; B2 f32 %d per admission, B4 %d "
          "per step; compile stats %s"
          % (len(outs), adm, steps, time.perf_counter() - t0, launches,
             launches["flash_attention"] // max(adm, 1),
             launches["decode_attention"] // max(steps, 1),
             pdense.compile_stats()))
    check(adm == len(dense_prompts) and
          launches["flash_attention"] == layers * adm and
          launches["decode_attention"] == layers * steps > 0 and
          launches["decode_attention_paged"] == 0 and
          launches["int8_matmul"] == 0,
          "program dense launches %s for %d admissions, %d steps"
          % (launches, adm, steps))
    check(pdense.compile_stats()["compiles"] == len(BUCKETS) + 1,
          "program dense compile stats %s" % pdense.compile_stats())
    program_streams("program-serve dense", outs, dense_outs, dense_prompts,
                    paged)
    out["flash_attention"] = launches["flash_attention"]
    out["decode_attention"] = launches["decode_attention"]

    # the paged cell, f32: its peak beside the module-served cell's
    (launches, outs, steps), peak = peak_above(
        lambda: serve_paged(ppaged, prompts, "program-serve paged"))
    check(launches["int8_matmul"] == 0,
          "the f32 program path launched int8_matmul")
    program_streams("program-serve paged", outs, paged_outs, prompts, paged)
    weights = sum(t.numel() * t.element_size()
                  for t in paged.model.reference_state().values())
    pools = sum(c.numel() * c.element_size()
                for pair in paged.model.caches for c in pair)
    mine = sum(ppaged.scope.find_var(n).numel() *
               ppaged.scope.find_var(n).element_size()
               for n, _, _ in ppaged.spec.cache_vars)
    m_cell, p_cell = weights + pools + paged_peak, weights + mine + peak
    print("[program-serve] paged cell peak: program route %.3f GB "
          "(weights %.3f GB, pools %.3f GB, %.1f MB above them while "
          "serving), module route %.3f GB (%.1f MB above); ratio %.4f "
          "(limit %.2f); B5 %d per step"
          % (p_cell / 1e9, weights / 1e9, mine / 1e9, peak / 1e6,
             m_cell / 1e9, paged_peak / 1e6, p_cell / m_cell,
             1 + PROGRAM_PEAK_RTOL,
             launches["decode_attention_paged"] // max(steps, 1)))
    check(mine == pools, "program pools %d bytes, module pools %d"
          % (mine, pools))
    check(p_cell <= (1 + PROGRAM_PEAK_RTOL) * m_cell,
          "the program-served paged cell's peak %.3f GB passes the module "
          "cell's %.3f GB by more than %g"
          % (p_cell / 1e9, m_cell / 1e9, PROGRAM_PEAK_RTOL))
    out["decode_attention_paged"] = launches["decode_attention_paged"]

    # the paged cell, int8 weights and bf16 pools
    launches, outs, steps = serve_paged(pquant, prompts,
                                        "program-serve int8/bf16")
    shapes = read_int8_shapes()
    print("[program-serve] int8/bf16: B3 %d launches = %d x (%d "
          "admissions + %d steps); by (m, k, n) %s"
          % (launches["int8_matmul"], INT8_PER_PASS, len(prompts), steps,
             sorted(shapes.items())))
    check(launches["int8_matmul"] == INT8_PER_PASS * (len(prompts) + steps),
          "program int8 launches %d != %d x (%d + %d)"
          % (launches["int8_matmul"], INT8_PER_PASS, len(prompts), steps))
    program_streams("program-serve int8/bf16", outs, quant_outs, prompts,
                    quant)
    out["decode_attention_paged bf16"] = launches["decode_attention_paged"]
    out["int8_matmul"] = launches["int8_matmul"]

    # speculative rounds through the verify program (the default 1-layer
    # self-draft, a dense program session on the same scope)
    pspec = GenerationSession(transformer_lm_session(
        **dict(paged_kw, decode_policy=DecodePolicy(speculate_k=SPEC_K))),
        program_scope(paged))
    d = pspec.draft
    d0 = (d.prefills, d.steps)
    launches, outs, steps = serve_paged(pspec, prompts,
                                        "program-serve speculative",
                                        plain=False)
    dpre, dsteps = d.prefills - d0[0], d.steps - d0[1]
    print("[program-serve] speculative: %d rounds, %d verifies, %d "
          "drafted, %d accepted, %d plain steps; draft %d admissions, %d "
          "steps; B5 %d = %d x (%d + %d), B2 %d, B4 %d"
          % (pspec.spec_rounds, pspec.verifies, pspec.spec_drafted,
             pspec.spec_accepted, steps, dpre, dsteps,
             launches["decode_attention_paged"], layers, steps,
             pspec.verifies, launches["flash_attention"],
             launches["decode_attention"]))
    check(pspec.verifies > 0 and launches["decode_attention_paged"] ==
          layers * (steps + pspec.verifies) and
          launches["flash_attention"] == dpre == len(prompts) and
          launches["decode_attention"] == dsteps > 0,
          "program speculative launches %s" % launches)
    program_streams("program-serve speculative", outs, paged_outs, prompts,
                    paged)
    out["verifies"] = pspec.verifies
    pspec.close()

    # TTFT per bucket and the decode step at 8 slots, in turns
    routes = (("module", sess), ("program", pdense))
    ttft = {name: {} for name, _ in routes}
    for p in BUCKETS:
        times = {name: [] for name, _ in routes}
        for _ in range(3):
            prompt = rng.integers(2, v, p)
            for name, s in routes:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                slot, _ = s.admit(prompt)
                times[name].append((time.perf_counter() - t0) * 1e3)
                s.retire(slot)
        for name in times:
            ttft[name][p] = sorted(times[name])[1]
    card = card_line()
    print("[program-serve] ttft_ms (idle server, median of 3, in turns; the "
          "program route replays each bucket's captured prefill) module "
          "%s, program %s; %s"
          % ({k: round(x, 3) for k, x in ttft["module"].items()},
             {k: round(x, 3) for k, x in ttft["program"].items()}, card))
    # the decode step at 8 slots, each cell's module and program routes
    # in turns, then one profiled step of each (the program route's steps
    # replay the decode program's CUDA graph)
    cells = {"dense": (sess, pdense), "paged": (paged, ppaged),
             "int8/bf16": (quant, pquant)}
    step_ms, busy = {}, {}
    for cell, pair in cells.items():
        routes = (("module", pair[0]), ("program", pair[1]))
        for s in pair:
            for slot in s.active_slots():
                s.retire(slot)
        for i in range(SLOTS):
            prompt = rng.integers(2, v, 64 + 56 * i)
            for _, s in routes:
                s.admit(prompt)
        for _, s in routes:
            for _ in range(3):
                s.step()
        rounds = {name: [] for name, _ in routes}
        for _ in range(LATENCY_ROUNDS):
            for name, s in routes:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(16):
                    s.step()
                rounds[name].append((time.perf_counter() - t0) * 1e3 / 16)
        step_ms[cell] = {name: float(np.median(r))
                         for name, r in rounds.items()}
        kernel = ("B4 (dense_decode_kernel)", ("dense_decode_kernel",)) \
            if cell == "dense" else ("B5 (paged_split_kernel)",
                                     ("paged_split_kernel",))
        busy[cell] = {}
        counter = "decode_attention" if cell == "dense" else \
            "decode_attention_paged"
        for name, s in routes:
            # the launches are held on the kernel counters (a replay counts
            # as its capture's launches); the profiler's count, which can
            # miss a launch at a session's start, is printed beside them
            got, launched = counted(functools.partial(
                profile_window, "%s %s route: 1 decode step, %d slots"
                % (cell, name, SLOTS), s.step, (kernel,)))
            busy[cell][name] = None if got is None else got["busy_share"]
            print("[program-serve] %s %s route's profiled decode step: %d "
                  "%s launches on the kernel counters (%d layers), %s in "
                  "the profiler's events" % (
                      cell, name, launched[counter], kernel[0], layers,
                      "not measured" if got is None else got[kernel[0]]))
            check(launched[counter] == layers,
                  "%s %s route's decode step launched %s %s kernels"
                  % (cell, name, launched[counter], kernel[0]))
        print("[program-serve] %s decode step at %d slots (median of %d "
              "rounds of 16, in turns): module %.3f ms, program %.3f ms "
              "(x%.2f; PR 14's program route, before capture: 10.484 ms "
              "dense); rounds module %s, program %s; one step's "
              "device-busy share module %s, program %s; %s"
              % (cell, SLOTS, LATENCY_ROUNDS, step_ms[cell]["module"],
                 step_ms[cell]["program"],
                 step_ms[cell]["program"] / step_ms[cell]["module"],
                 [round(r, 3) for r in rounds["module"]],
                 [round(r, 3) for r in rounds["program"]],
                 busy[cell]["module"], busy[cell]["program"], card))
        for s in pair:
            for slot in s.active_slots():
                s.retire(slot)
    print("[program-serve] captured steps (CUDA graphs) a session: dense "
          "%s, paged %s, int8/bf16 %s; compile stats %s"
          % (pdense.exe.capture_stats(), ppaged.exe.capture_stats(),
             pquant.exe.capture_stats(),
             {k: s.compile_stats() for k, s in (("dense", pdense),
                                                ("paged", ppaged),
                                                ("int8/bf16", pquant))}))
    check(all(s.exe.capture_stats()["captures"] > 0 and
              s.exe.capture_stats()["failed"] == 0
              for s in (pdense, ppaged, pquant)),
          "[program-serve] the program sessions captured no step")
    out.update(ttft=ttft, step_ms=step_ms, busy=busy)
    for s in (pdense, ppaged, pquant):
        s.close()
    return out


def phase_program_generation(seed):
    """[program-generation]: bench.py's ``bench_generation`` on the
    accelerator through the port's program route: PROGRAM_GENERATION's
    weights from its ``transformer_lm`` program's startup on the card,
    ``transformer_lm_session`` (8 slots, max_len and cache 128, prompt
    bucket 8) and ``GenerationSession(spec, scope)``: 8 prompts of 4
    tokens, a warm step, TTFT of ``[0]`` (median of 5), then 64 timed
    steps; then the same weights armed for int8 compute (the scope
    quantized in place) and the steps again. Checks 2 compiles for each
    (one bucket and the decode shape) and the launches per admission and
    step."""
    import torch
    from paddle_tpu_torch import core
    from paddle_tpu_torch.models.transformer import (lm_param_names,
                                                     transformer_lm_session)
    from paddle_tpu_torch.serving import GenerationSession
    cfg = PROGRAM_GENERATION
    slots, steps = PROGRAM_GENERATION_SLOTS, PROGRAM_GENERATION_STEPS
    max_len, vocab = 2 * steps, cfg["vocab_size"]
    _, startup, _, _ = lm_program(cfg, max_len, is_test=True)
    startup.random_seed = seed
    scope = core.Scope()
    core.Executor(device="cuda").run(startup, scope=scope)
    check(set(lm_param_names(cfg["num_layers"])) <= set(scope.var_names()),
          "the startup made %s" % sorted(scope.var_names()))
    per_step = {"float32": {"decode_attention": cfg["num_layers"]},
                "int8": {"decode_attention": cfg["num_layers"],
                         "int8_matmul": 6 * cfg["num_layers"] + 1}}
    got = {}
    for dtype, arm in (("float32", False), ("int8", True)):
        spec = transformer_lm_session(
            max_len=max_len, slots=slots, cache_len=max_len,
            prompt_buckets=(8,), device="cuda", decode_policy=None, **cfg)
        sess = GenerationSession(spec, scope, arm_quant=arm)
        rs = np.random.RandomState(0)

        def fill():
            return [sess.admit(list(rs.randint(2, vocab, 4)))[0]
                    for _ in range(slots - len(sess.active_slots()))]
        fill()
        sess.step()
        ttft = []
        if not arm:
            for s in sess.active_slots():
                sess.retire(s)
            for _ in range(5):
                t0 = time.perf_counter()
                slot, _ = sess.admit([0])
                ttft.append((time.perf_counter() - t0) * 1e3)
                sess.retire(slot)
            fill()
        reset_launches()
        step_ms = []
        t0 = time.perf_counter()
        for _ in range(steps):
            t1 = time.perf_counter()
            sess.step()
            step_ms.append((time.perf_counter() - t1) * 1e3)
        dt = time.perf_counter() - t0
        launches = read_launches()
        stats = sess.compile_stats()
        got[dtype] = dict(tokens_per_sec=slots * steps / dt,
                          inter_token_ms=float(np.median(step_ms)),
                          ttft_ms=float(np.median(ttft)) if ttft else None,
                          compiles=stats["compiles"])
        print("[program-generation] %s: decode_tokens_per_sec %.1f, "
              "inter_token_ms %.3f%s; compile stats %s; launches over %d "
              "steps %s; armed %d weights"
              % (dtype, got[dtype]["tokens_per_sec"],
                 got[dtype]["inter_token_ms"],
                 "" if not ttft else ", time_to_first_token_ms %.3f"
                 % got[dtype]["ttft_ms"], stats, steps, launches,
                 len(sess._quant_armed)))
        check(stats["compiles"] == 2,
              "%s generation shape set not closed: %d compiles for 1 prompt "
              "bucket + 1 decode shape" % (dtype, stats["compiles"]))
        want = {k: n * steps for k, n in per_step[dtype].items()}
        check(all(launches[k] == want.get(k, 0) for k in launches),
              "%s launches %s over %d steps, expected %s"
              % (dtype, launches, steps, want))
        check(not arm or len(sess._quant_armed) ==
              per_step["int8"]["int8_matmul"],
              "int8 compute armed %d weights" % len(sess._quant_armed))
        sess.close()
    return got


def phase_time_flash_bf16(lm_launches, err, sweep):
    """B2 bf16 at the path's shape: its time between CUDA events over
    queued calls and from the profiler, launches a step, the bound, and
    the times of the plain version and of F.scaled_dot_product_attention
    on the same causal bf16 inputs (a yardstick, never on the path), all
    between events; then a row for each tile of T2."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.probes.common import cuda_ms
    b, h, t, d = LM_ATTN
    q, k, v, _ = flash_inputs(*LM_ATTN)
    kernel = functools.partial(fa.flash_attention, q, k, v, True)
    ms, profiler_ms = two_clocks(kernel)
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, True),
                       iters=10)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), iters=10)
    pairs = t * (t + 1) // 2           # attendable (query, key) pairs
    flops = 4 * d * b * h * pairs      # QK^T and PV, 2 flops per MAC
    nbytes = 2 * 4 * b * h * t * d     # q, k, v read, o written, bf16
    bound, bound_by = roofline_ms(nbytes, flops, BF16_FLOPS)
    f32_bound, _ = roofline_ms(nbytes, flops, F32_FLOPS)
    # the f32 peak bound is printed beside, as the yardstick of a kernel
    # that runs its products on the CUDA cores
    per_step = lm_launches["flash_attention bf16"] // (LM_WINDOWS
                                                       * LM_WINDOW_STEPS)
    print("[time] flash_attention bf16 %s causal, tile %dx%d: %.4f ms "
          "between CUDA events (profiler kernel sum %.4f ms; bound %.4f ms by "
          "%s at the bf16 tensor-core peak; %.4f ms at the f32 CUDA-core "
          "peak), plain %.4f ms, "
          "F.scaled_dot_product_attention %.4f ms; %d launches a step, %.3f "
          "ms a step" % ((list(LM_ATTN),) + fa.PATH_TILES[d]
                         + (ms, profiler_ms, bound, bound_by, f32_bound,
                            plain_ms, lib_ms, per_step, per_step * ms)))
    source = "paddle_tpu_torch/csrc/flash_attention.cu"
    rows = [dict(name="flash_attention", route="cuda", source=source,
                 replaces="paddle_tpu/ops/pallas_attention.py:584",
                 launches=lm_launches["flash_attention bf16"],
                 launches_in="[lm-train]", max_abs_err=err, ms=ms,
                 plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                 library_ms=lib_ms, dtype="bfloat16", shape=list(LM_ATTN),
                 tile=list(fa.PATH_TILES[d]), f32_peak_bound_ms=f32_bound)]
    for tile, r in sweep.items():
        on_path = tile == fa.PATH_TILES[d]
        rows.append(dict(
            name="flash_attention_tile", route="cuda", source=source,
            replaces="tools/transformer_mfu_probe.py:127",
            launches=rows[0]["launches"] if on_path else 0,
            launches_in="[lm-train], the path's tile" if on_path
            else "the sweep only (probes/flash.py)",
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
            library_ms=lib_ms, dtype="bfloat16", shape=list(LM_ATTN),
            tile=list(tile)))
    del q, k, v
    return rows


# [engine]: the flagship LM's forward program (is_test, tokens declared
# at ENGINE_T, bench.py's widths at full depth) exported through
# io.save_inference_model (f32; int8; the f32 export merged into one
# file), its weights from the program's startup on the card (seed), and
# served by ServingEngine at ENGINE_BUCKETS (not the serving_buckets
# default (1, 8, 32): warmup on the card stays bounded) on
# ENGINE_REPLICAS replicas of the one card, breakers after
# ENGINE_BREAKER_FAILURES failures, a cooldown of ENGINE_COOLDOWN_MS and a
# per-call timeout of ENGINE_TIMEOUT_S; 1-row requests from
# ENGINE_CLIENTS client threads (ENGINE_PER_CLIENT each) through
# MicroBatcher(max_batch 8, max_delay ENGINE_DELAY_MS), each answer within
# ENGINE_ROW_RTOL of max|logits| of the same row alone in bucket 1 (the
# 12-layer logits limit of PERF.md: cuBLAS may take another algorithm at
# m = 8 x 512 than at 512); ENGINE_TIMED_RUNS timed batches a bucket
ENGINE_T = 512
# the LM of [engine] and [aot]: the flagship's full width at half its
# depth, 6 of 12 layers (a depth cut for the script's 1200 s; the fleet
# phases serve all 12)
ENGINE_LM = dict(FULL, num_layers=6)
ENGINE_BUCKETS = (1, 8)
ENGINE_REPLICAS = 2
ENGINE_BREAKER_FAILURES = 2
ENGINE_COOLDOWN_MS = 500.0
ENGINE_TIMEOUT_S = 120.0
ENGINE_CLIENTS, ENGINE_PER_CLIENT = 8, 8
ENGINE_DELAY_MS = 5.0
ENGINE_TIMED_RUNS = 5
ENGINE_ROW_RTOL = 1e-3
# the card against the CPU: SMALL_PROGRAM_LM at T ENGINE_SMALL_T exported
# from a CPU startup, served at ENGINE_SMALL_BUCKETS on both devices, a
# batch of ENGINE_SMALL_BATCH rows: f32 within ENGINE_CARD_CPU_RTOL of
# max|logits|, int8 within LM_INT8_STEPS head quantization steps (the
# armed forward's bound of tests/test_torch_program_quant.py)
ENGINE_SMALL_T, ENGINE_SMALL_BATCH = 64, 3
ENGINE_SMALL_BUCKETS = (1, 4)
ENGINE_CARD_CPU_RTOL = 1e-4
# ResNet-50 as bench.py builds it, exported under is_test (224 x 224)
ENGINE_RESNET = dict(depth=50, res=224, class_dim=1000)


def lm_cfg(cfg):
    return {k: v for k, v in cfg.items() if k != "max_len"}


def engine_export(cfg, t, seed, device, dirs, compiled=None):
    """The LM's forward program (is_test) at T ``t``, its startup's
    weights drawn from ``seed`` on ``device``, exported to each path of
    ``dirs`` ({path: quantize}), with each bucket of ``compiled`` (a
    tuple) exported under ``compiled/``. Returns ({path: seconds}, the
    scope the weights were exported from)."""
    from paddle_tpu_torch import core, io
    main, startup, _, logits = lm_program(lm_cfg(cfg), t, is_test=True)
    startup.random_seed = seed
    exe, scope = core.Executor(device=device), core.Scope()
    exe.run(startup, scope=scope)
    out = main.global_block().var(logits)
    secs = {}
    for d, quantize in dirs.items():
        t0 = time.perf_counter()
        io.save_inference_model(d, ["toks"], [out], exe, main_program=main,
                                scope=scope, quantize=quantize,
                                export_compiled=compiled is not None,
                                export_buckets=compiled)
        secs[d] = time.perf_counter() - t0
    return secs, scope


def counted_engine(path, device="cuda", **kw):
    """A ServingEngine over ``path`` whose executions (batches, warmup,
    probes, canaries) count in ``eng.executions``; built without warmup,
    then warmed. Returns (engine, seconds of construction + warmup)."""
    import threading
    from paddle_tpu_torch.serving import ServingEngine
    t0 = time.perf_counter()
    eng = ServingEngine(path, warmup=False, device=device, **kw)
    lock = threading.Lock()
    eng.executions = 0
    execute, canary = eng._execute, eng._run_canary

    def count():
        with lock:
            eng.executions += 1

    def _execute(rep, feed, bucket):
        out = execute(rep, feed, bucket)
        count()
        return out

    def _run_canary(new_host):
        canary(new_host)
        count()

    eng._execute, eng._run_canary = _execute, _run_canary
    eng.warmup()
    return eng, time.perf_counter() - t0


def f32_flash(launches):
    return launches["flash_attention"] - launches["flash_attention bf16"]


def engine_held(before, executions, per_execution):
    """The launches since ``before`` (read_launches()) are the engine's
    ``executions``: B2 f32 ``per_execution[0]`` and B3 ``[1]`` each, and
    no other kernel."""
    now = read_launches()
    delta = {k: now[k] - before[k] for k in now}
    got = {"flash_attention f32": f32_flash(delta),
           "int8_matmul": delta["int8_matmul"]}
    want = {"flash_attention f32": per_execution[0] * executions,
            "int8_matmul": per_execution[1] * executions}
    others = {k: v for k, v in delta.items() if v and k not in (
        "flash_attention", "int8_matmul")}
    check(got == want and not others,
          "[engine] launches %s (and %s) != %s for %d executions"
          % (got, others, want, executions))


def direct_run(eng, rows, rep=0, scope=None):
    """The engine's program run by a replica's executor on its scope (or
    ``scope``), launches uncounted."""
    import torch
    rep = eng.replicas[rep]
    feed = {eng.feed_names[0]: torch.tensor(rows, device=rep.device)}
    return uncounted(lambda: rep.exe.run(
        eng.program, feed=feed, fetch_list=eng.fetch_names,
        scope=scope if scope is not None else rep.scope))[0]


def scope_bytes(scope, names=None):
    return sum(v.numel() * v.element_size() for n, v in scope.items()
               if names is None or n in names)


def bucket_times(eng, rows):
    """{bucket: (median host ms of ENGINE_TIMED_RUNS eng.run of a full
    bucket, the mean of paddle_serving_batch_seconds over them, and the
    median of the same program run by replica 0's executor with its
    logits left on the card, ended by a synchronize, in ms)}."""
    import torch
    from paddle_tpu_torch.observability import metrics
    hist = metrics.REGISTRY._families["paddle_serving_batch_seconds"]
    rep = eng.replicas[0]
    out = {}
    for b in eng.buckets:
        child = hist.labels(bucket=b)
        n0, s0 = child.count, child.sum
        ms = []
        for _ in range(ENGINE_TIMED_RUNS):
            t0 = time.perf_counter()
            eng.run({"toks": rows[:b]})
            ms.append((time.perf_counter() - t0) * 1e3)
        feed = {eng.feed_names[0]: torch.tensor(rows[:b], device=rep.device)}

        def on_card():
            t0 = time.perf_counter()
            rep.exe.run(eng.program, feed=feed, fetch_list=eng.fetch_names,
                        scope=rep.scope, return_numpy=False)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        kept = uncounted(lambda: [on_card()
                                  for _ in range(ENGINE_TIMED_RUNS)])
        out[b] = (float(np.median(ms)),
                  (child.sum - s0) / max(child.count - n0, 1) * 1e3,
                  float(np.median(kept)))
    return out


def engine_traffic(eng, rows):
    """ENGINE_CLIENTS threads, each sending ENGINE_PER_CLIENT 1-row
    requests in turn through a MicroBatcher. Returns ({request index:
    its answer}, [latency ms], wall seconds)."""
    import threading
    from paddle_tpu_torch.serving import MicroBatcher
    mb = MicroBatcher(eng, max_batch=8, max_delay_ms=ENGINE_DELAY_MS)
    answers, lat, errors = {}, [], []

    def client(c):
        try:
            for j in range(ENGINE_PER_CLIENT):
                i = c * ENGINE_PER_CLIENT + j
                t0 = time.perf_counter()
                answers[i] = mb.submit({"toks": rows[i]}).result(600)[0]
                lat.append((time.perf_counter() - t0) * 1e3)
        except Exception as exc:  # noqa: BLE001 (reported below)
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(ENGINE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    mb.close()
    check(not errors, "MicroBatcher requests failed: %r" % errors[:2])
    return answers, lat, wall


def rel_err(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(float(np.abs(np.asarray(b)).max()), 1e-30))


def phase_engine(seed, smi, rng):
    """[engine]: see ENGINE_T's comment. Returns the engine's launches of
    B2 f32 and of B3 over the phase ({"flash_attention": n,
    "int8_matmul": n})."""
    import os
    import shutil
    import tempfile
    import torch
    from paddle_tpu_torch import config
    from paddle_tpu_torch.models.transformer import lm_mul_weight_names
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.serving import SwapRejectedError
    from paddle_tpu_torch.serving import deploy
    from paddle_tpu_torch.utils.merge_model import merge_inference_model
    card = smi[0] if smi else "nvidia-smi: no output"
    cfg = lm_cfg(ENGINE_LM)
    L, vocab, t = cfg["num_layers"], cfg["vocab_size"], ENGINE_T
    armed_per = 6 * L + 1
    tmp = tempfile.mkdtemp(prefix="engine_")
    engines = []
    kw = dict(buckets=ENGINE_BUCKETS, replicas=ENGINE_REPLICAS,
              breaker_failures=ENGINE_BREAKER_FAILURES,
              breaker_cooldown_ms=ENGINE_COOLDOWN_MS,
              timeout=ENGINE_TIMEOUT_S)
    batches_total = metrics.REGISTRY._families[
        "paddle_serving_batches_total"]
    try:
        free = shutil.disk_usage(tmp).free
        d32, d8 = os.path.join(tmp, "f32"), os.path.join(tmp, "int8")
        t0 = time.perf_counter()
        secs, _ = uncounted(lambda: engine_export(
            ENGINE_LM, t, seed, "cuda", {d32: None, d8: "int8"}))
        export_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        size = {d: sum(os.path.getsize(os.path.join(d, f))
                       for f in os.listdir(d)) for d in (d32, d8)}
        print("[engine] exported the LM's forward program (T %d, %s) f32 "
              "in %.2f s (%.3f GB) and int8 in %.2f s (%.3f GB), with its "
              "startup on the card %.2f s; %.1f GB free on the temporary "
              "disk" % (t, cfg, secs[d32], size[d32] / 1e9, secs[d8],
                        size[d8] / 1e9, export_s, free / 1e9))
        rows = rng.integers(2, vocab, (ENGINE_CLIENTS * ENGINE_PER_CLIENT,
                                       t)).astype(np.int32)

        # -- the f32 engine: cold start, warmup, a bucket-8 batch -----------
        reset_launches()
        before = read_launches()
        t0 = time.perf_counter()
        eng, build_s = counted_engine(d32, **kw)
        engines.append(eng)
        first = eng.run({"toks": rows[:1]})[0]
        cold_ms = (time.perf_counter() - t0) * 1e3
        on_card = all(r.device.type == "cuda" and
                      all(v.device == r.device for _, v in r.scope.items())
                      for r in eng.replicas)
        batch = [eng.run({"toks": rows[:8]})[0] for _ in eng.replicas]
        direct = direct_run(eng, rows[:8])
        check(on_card and first.shape == (1, t, vocab) and
              np.isfinite(first).all(),
              "[engine] replicas on the card %s, first response %s"
              % (on_card, first.shape))
        check(all(np.array_equal(b, direct) for b in batch),
              "[engine] a bucket-8 batch differs from a direct run "
              "(max %s)" % [float(np.abs(b - direct).max()) for b in batch])
        f32_bytes = scope_bytes(eng.replicas[0].scope)
        print("[engine] f32 engine, buckets %s, %d replicas on %s: cold "
              "start (construction + warmup + first response) %.1f ms, "
              "construction + warmup %.1f ms; a bucket-8 batch on each "
              "replica equal to a direct run of the pruned program: True; "
              "weights %.3f GB a replica; %s"
              % (ENGINE_BUCKETS, len(eng.replicas),
                 sorted({str(r.device) for r in eng.replicas}), cold_ms,
                 build_s * 1e3, f32_bytes / 1e9, card))

        # -- traffic through the micro-batcher ------------------------------
        alone = {i: eng.run({"toks": rows[i:i + 1]})[0][0]
                 for i in range(len(rows))}
        b0 = sum(c.value for c in batches_total.children().values())
        answers, lat, wall = engine_traffic(eng, rows)
        batches = sum(c.value for c in batches_total.children().values()) \
            - b0
        worst = max(rel_err(answers[i], alone[i]) for i in alone)
        check(len(answers) == len(rows) and worst <= ENGINE_ROW_RTOL,
              "[engine] batched answers vs rows alone: %.3g > %g"
              % (worst, ENGINE_ROW_RTOL))
        times32 = bucket_times(eng, rows)
        engine_held(before, eng.executions, (L, 0))
        print("[engine] MicroBatcher, %d clients x %d 1-row requests: "
              "%.2f requests/s, latency p50 %.1f ms, p99 %.1f ms, %d "
              "batches (%.2f rows a batch); each answer against its row "
              "alone in bucket 1: max %.3g of max|logits| (limit %g); B2 "
              "f32 %d launches over the engine's %d executions so far, "
              "warmup included (%d an execution); %s"
              % (ENGINE_CLIENTS, ENGINE_PER_CLIENT, len(rows) / wall,
                 np.percentile(lat, 50), np.percentile(lat, 99), batches,
                 len(rows) / max(batches, 1), worst, ENGINE_ROW_RTOL,
                 f32_flash(read_launches()) - f32_flash(before),
                 eng.executions, L, card))
        print("[engine] f32 batch time by bucket (median of %d eng.run, "
              "host clock with the padding and the logits' copy to the "
              "host; the mean of paddle_serving_batch_seconds; the "
              "program with its logits kept on the card): %s; %s"
              % (ENGINE_TIMED_RUNS, {b: "%.2f ms (%.2f; %.2f)" % v
                                     for b, v in times32.items()}, card))

        # -- breakers, failover and the probe -------------------------------
        before, n0 = read_launches(), eng.executions
        failover = metrics.REGISTRY._families["paddle_serving_failover_total"]
        fo0 = failover.value
        faults.arm("serving_replica_fail", at=0, times=None)
        t_fault = time.perf_counter()
        try:
            outs = [eng.run({"toks": rows[:1]})[0] for _ in range(4)]
            health = eng.replica_health()
        finally:
            faults.disarm()
        t_off = time.perf_counter()
        while eng.replica_health()[0] != "closed" and \
                time.perf_counter() - t_off < 60.0:
            time.sleep(0.005)
        t_back = time.perf_counter()
        worst = max(rel_err(o[0], alone[0]) for o in outs)
        check(health == ["open", "closed"] and
              eng.replica_health() == ["closed", "closed"] and
              worst <= ENGINE_ROW_RTOL,
              "[engine] failover: health %s then %s, answers %.3g"
              % (health, eng.replica_health(), worst))
        engine_held(before, eng.executions - n0, (L, 0))
        print("[engine] serving_replica_fail on replica 0: 4 of 4 requests "
              "answered by replica 1 (max %.3g of max|logits| from the row "
              "alone), %d failovers, breakers %s; disarmed, the probe "
              "re-admitted replica 0 after %.1f ms (fault to re-admission "
              "%.1f ms, cooldown %.0f ms); %s"
              % (worst, failover.value - fo0, health,
                 (t_back - t_off) * 1e3, (t_back - t_fault) * 1e3,
                 ENGINE_COOLDOWN_MS, card))

        # -- the merged single file -----------------------------------------
        merged = os.path.join(tmp, "f32.ptpu")
        t0 = time.perf_counter()
        merge_inference_model(d32, merged)
        merge_s = time.perf_counter() - t0
        before = read_launches()
        engm, mbuild_s = counted_engine(merged, buckets=ENGINE_BUCKETS)
        got = engm.run({"toks": rows[:8]})[0]
        check(np.array_equal(got, batch[0]),
              "[engine] the merged-file engine differs from the directory "
              "engine")
        engine_held(before, engm.executions, (L, 0))
        engm.close()
        del engm, got
        os.remove(merged)
        print("[engine] the f32 export merged into one file in %.2f s; an "
              "engine on it built and warmed in %.2f s, its bucket-8 batch "
              "equal to the directory engine's: True; %s"
              % (merge_s, mbuild_s, card))

        # -- hot swaps ------------------------------------------------------
        d32b = os.path.join(tmp, "f32_seed1")
        _, sb = uncounted(lambda: engine_export(ENGINE_LM, t, seed + 1,
                                                "cuda",
                                                {d32b: None}))
        hist = deploy.SWAP_BLACKOUT_SECONDS.labels()
        s0, c0 = hist.sum, hist.count
        before, n0 = read_launches(), eng.executions
        t0 = time.perf_counter()
        version = eng.swap_weights(d32b, watch_requests=0)
        swap_s = time.perf_counter() - t0
        check(hist.count == c0 + 1, "[engine] the swap recorded no blackout")
        blackout_ms = (hist.sum - s0) * 1e3
        after = [eng.run({"toks": rows[:8]})[0] for _ in eng.replicas]
        # the program run on the very weights the seed-1 artifact holds
        want = direct_run(eng, rows[:8], scope=sb)
        del sb
        torch.cuda.empty_cache()
        check(version == 1 and all(np.array_equal(a, want) for a in after)
              and not np.array_equal(after[0], batch[0]),
              "[engine] after the swap: outputs vs a direct run on the "
              "seed-1 weights")
        # the push: the int8 export, which loads dequantized into the f32
        # engine's signature and so reaches the canary
        faults.arm("swap_canary_fail", times=1)
        rejected = False
        try:
            eng.swap_weights(d8, watch_requests=0)
        except SwapRejectedError:
            rejected = True
        finally:
            faults.disarm()
        still = eng.run({"toks": rows[:8]})[0]
        check(rejected and eng.weights_version == 1 and
              np.array_equal(still, after[0]),
              "[engine] a push under swap_canary_fail: rejected %s, "
              "outputs unchanged %s" % (rejected,
                                        np.array_equal(still, after[0])))
        engine_held(before, eng.executions - n0, (L, 0))
        print("[engine] swap_weights onto a seed-1 export: %.2f s (verify, "
              "load, canary, stage), blackout %.4f ms "
              "(paddle_deploy_swap_blackout_seconds); outputs equal a "
              "direct run on the seed-1 weights: True; a push under "
              "swap_canary_fail rejected, outputs bitwise as before: "
              "True; %s" % (swap_s, blackout_ms, card))
        shutil.rmtree(d32b, ignore_errors=True)
        eng.close()
        engines.remove(eng)
        del eng, batch, after, alone, answers, outs, want, still, direct
        gc.collect()
        torch.cuda.empty_cache()

        # -- the int8 engine ------------------------------------------------
        before = read_launches()
        config.set_flags(serving_quant_compute=True)
        try:
            eng8, build8_s = counted_engine(d8, **kw)
        finally:
            config.set_flags(serving_quant_compute=False)
        engines.append(eng8)
        armed = sorted(eng8.program._quant_compute["vars"])
        int8_ok = all(r.scope.find_var(n).dtype == torch.int8 and
                      r.scope.find_var(n + "@quant.scale").dtype ==
                      torch.float32 for r in eng8.replicas for n in armed)
        check(armed == sorted(lm_mul_weight_names(L)) and
              len(armed) == armed_per and int8_ok,
              "[engine] int8 engine: %d armed names, int8 in the scope %s"
              % (len(armed), int8_ok))
        b8 = [eng8.run({"toks": rows[:8]})[0] for _ in eng8.replicas]
        direct8 = direct_run(eng8, rows[:8])
        check(all(np.array_equal(b, direct8) for b in b8) and
              np.isfinite(direct8).all(),
              "[engine] an int8 bucket-8 batch differs from a direct armed "
              "run")
        times8 = bucket_times(eng8, rows)
        engine_held(before, eng8.executions, (L, armed_per))
        int8_bytes = scope_bytes(eng8.replicas[0].scope)
        armed_bytes = scope_bytes(eng8.replicas[0].scope, set(armed))
        print("[engine] int8 engine (serving_quant_compute): %d armed "
              "names kept int8 in each replica's scope, no f32 copy; "
              "weights %.3f GB a replica against the f32 engine's %.3f "
              "(the armed products %.3f GB); built and warmed in %.2f s; "
              "a bucket-8 batch on each replica equal to a direct armed "
              "run: True; B3 %d an execution, B2 f32 %d; batch time by "
              "bucket (median, histogram mean; logits kept on the card): "
              "%s; %s"
              % (len(armed), int8_bytes / 1e9, f32_bytes / 1e9,
                 armed_bytes / 1e9, build8_s, armed_per, L,
                 {b: "%.2f ms (%.2f; %.2f)" % v for b, v in times8.items()},
                 card))
        eng8.close()
        engines.remove(eng8)
        del eng8, b8, direct8
        gc.collect()
        torch.cuda.empty_cache()

        # -- the card against the CPU ---------------------------------------
        small = lm_cfg(SMALL_PROGRAM_LM)
        sl = small["num_layers"]
        ds32, ds8 = os.path.join(tmp, "s32"), os.path.join(tmp, "s8")
        engine_export(small, ENGINE_SMALL_T, seed, "cpu",
                      {ds32: None, ds8: "int8"})
        srows = rng.integers(2, small["vocab_size"], (
            ENGINE_SMALL_BATCH, ENGINE_SMALL_T)).astype(np.int32)
        res = {}
        for name, path, quant in (("f32", ds32, False), ("int8", ds8, True)):
            before = read_launches()
            config.set_flags(serving_quant_compute=quant)
            try:
                ec, _ = counted_engine(path, buckets=ENGINE_SMALL_BUCKETS)
                # the CPU engine is the comparison's reference: its plain
                # versions are not the card's launches
                eh, _ = uncounted(lambda: counted_engine(
                    path, device="cpu", buckets=ENGINE_SMALL_BUCKETS))
            finally:
                config.set_flags(serving_quant_compute=False)
            a = ec.run({"toks": srows})[0]
            b = uncounted(lambda: eh.run({"toks": srows})[0])
            engine_held(before, ec.executions,
                        (sl, 6 * sl + 1 if quant else 0))
            diff = float(np.abs(a - b).max())
            if quant:
                sc = eh.replicas[0].scope
                ln = "layer_norm_%d" % (2 * sl)
                amax = (small["d_model"] - 1) ** 0.5 * float(
                    sc.find_var(ln + ".w_0").abs().max()) + float(
                    sc.find_var(ln + ".w_1").abs().max())
                tol = LM_INT8_STEPS * amax * float(
                    sc.find_var("lm_head.w@quant.scale").max())
            else:
                tol = ENGINE_CARD_CPU_RTOL * float(np.abs(b).max())
            res[name] = (diff, tol, rel_err(a, b))
            ec.close()
            eh.close()
            check(diff <= tol and np.isfinite(a).all(),
                  "[engine] %s card vs CPU: %.3g > %.3g" % (name, diff, tol))
        print("[engine] a 2-layer LM artifact (%s, T %d) served on the card "
              "and on the CPU, batch %d in bucket %d: %s; %s"
              % (small, ENGINE_SMALL_T, ENGINE_SMALL_BATCH,
                 ENGINE_SMALL_BUCKETS[-1],
                 {k: "max abs diff %.3g (tol %.3g, %.3g of max|logits|)"
                  % v for k, v in res.items()}, card))

        # -- ResNet-50 under is_test ----------------------------------------
        print("[engine] %s" % engine_resnet(seed, tmp, card))
        total = read_launches()
        check(all(v == 0 for k, v in total.items() if k not in (
            "flash_attention", "int8_matmul")) and
            total["flash_attention bf16"] == 0,
            "[engine] launched %s" % total)
    finally:
        for e in engines:
            e.close()
        faults.disarm()
        config.set_flags(serving_quant_compute=False)
        shutil.rmtree(tmp, ignore_errors=True)
    return {"flash_attention": f32_flash(total),
            "int8_matmul": total["int8_matmul"]}



# [aot]: the flagship LM's forward program (is_test, T ENGINE_T, batch 1)
# stored to a compile cache dir by this process and loaded by a child
# process; then [engine]'s f32 and int8 artifacts exported with compiled/
# buckets and served beside the same artifacts without them
AOT_CHILD_TIMEOUT_S = 600


def aot_forward(cache_dir, seed):
    """The flagship LM's forward program on the card, its startup weights
    drawn from ``seed``, run once by a fresh executor with the
    ``compile_cache_dir`` flag at ``cache_dir``. Returns (its logits,
    {the cache's hits, misses and quarantines, and the exports the run
    made}, seconds of the run)."""
    import torch
    from paddle_tpu_torch import config, core
    from paddle_tpu_torch.core import executor
    from paddle_tpu_torch.observability import metrics
    cfg = lm_cfg(ENGINE_LM)
    main, startup, _, logits = lm_program(cfg, ENGINE_T, is_test=True)
    startup.random_seed = seed
    exe, scope = core.Executor(device="cuda"), core.Scope()
    uncounted(lambda: exe.run(startup, scope=scope))
    ids = np.random.RandomState(seed).randint(
        2, cfg["vocab_size"], (1, ENGINE_T)).astype(np.int32)
    names = {k: "paddle_deploy_cache_%s_total" % k
             for k in ("hits", "misses", "quarantined")}
    before = {k: metrics.REGISTRY.counter(n).value for k, n in names.items()}
    real, made = executor._export, []

    def counting(*a, **k):
        made.append(1)
        return real(*a, **k)
    executor._export = counting
    config.set_flags(compile_cache_dir=cache_dir)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, = exe.run(main, feed={"toks": ids, "lbls": ids},
                       fetch_list=[logits], scope=scope)
        secs = time.perf_counter() - t0
    finally:
        config.set_flags(compile_cache_dir=None)
        executor._export = real
    stats = {k: metrics.REGISTRY.counter(n).value - before[k]
             for k, n in names.items()}
    stats["exports"] = len(made)
    return out, stats, secs


def aot_child(cache_dir, seed, out_path):
    """[aot]'s child process (``python -c``, importing only the port):
    one :func:`aot_forward` on ``cache_dir``; saves the logits to
    ``out_path`` and prints ``AOT_CHILD`` and its stats as JSON."""
    from paddle_tpu_torch.place import resolve_device
    resolve_device("cuda")      # TF32 off, as in the parent
    out, stats, secs = aot_forward(cache_dir, seed)
    np.save(out_path, out)
    stats["seconds"] = secs
    print("AOT_CHILD %s" % json.dumps(stats))


def aot_engine(path, quant, kw, rows, push):
    """One engine over ``path`` (int8 compute when ``quant``): cold start
    (construction + warmup + first response), the AOT loads and
    fallbacks it counted, its bucket-8 and bucket-1 answers, the batch
    times by bucket, a swap onto ``push`` (the flip's blackout and the
    first bucket-8 batch after it, which recaptures), and the launches
    held to its executions. Returns a dict of those."""
    import torch
    from paddle_tpu_torch import config
    from paddle_tpu_torch.serving import deploy
    loads, falls = deploy.AOT_LOADS, deploy.AOT_FALLBACKS
    l0, f0 = loads.value, falls.value
    before = read_launches()
    config.set_flags(serving_quant_compute=quant)
    try:
        t0 = time.perf_counter()
        eng, build_s = counted_engine(path, **kw)
        first = eng.run({"toks": rows[:1]})[0]
        cold_ms = (time.perf_counter() - t0) * 1e3
        res = dict(cold_ms=cold_ms, build_s=build_s, first=first,
                   loads=loads.value - l0, fallbacks=falls.value - f0,
                   primed=sum(e.aot is not None for r in eng.replicas
                              for e in r.exe._cache.values()),
                   graphs=sum(e.graph is not None for r in eng.replicas
                              for e in r.exe._cache.values()))
        res["b8"] = eng.run({"toks": rows[:8]})[0]
        res["b1"] = eng.run({"toks": rows[1:2]})[0]
        res["times"] = bucket_times(eng, rows)
        hist = deploy.SWAP_BLACKOUT_SECONDS.labels()
        s0 = hist.sum
        recaptures0 = sum(r.exe.capture_stats()["recaptures"]
                          for r in eng.replicas)
        eng.swap_weights(push, watch_requests=0)
        res["blackout_ms"] = (hist.sum - s0) * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res["after"] = eng.run({"toks": rows[:8]})[0]
        res["after_ms"] = (time.perf_counter() - t0) * 1e3
        for _ in eng.replicas[1:]:
            check(np.array_equal(eng.run({"toks": rows[:8]})[0],
                                 res["after"]),
                  "[aot] the replicas answer differently after the swap")
        res["recaptures"] = sum(r.exe.capture_stats()["recaptures"]
                                for r in eng.replicas) - recaptures0
        res["executions"] = eng.executions
        res["launches"] = {k: read_launches()[k] - before[k]
                           for k in before}
        eng.close()
    finally:
        config.set_flags(serving_quant_compute=False)
    return res


def phase_aot(seed, smi, rng):
    """[aot]: see AOT_CHILD_TIMEOUT_S's comment. The child must show one
    cache hit, no export and logits bitwise equal to this process's; a
    byte flipped in the stored blob is quarantined and the step rebuilt;
    the artifacts' engines prime every bucket of every replica (no
    fallback), answer bitwise as the same artifacts' engines without
    compiled/, and launch B2 f32 L (B3 6L + 1) an execution, L the
    layers of ENGINE_LM."""
    import os
    import shutil
    import tempfile
    import torch
    card = smi[0] if smi else "nvidia-smi: no output"
    cfg = lm_cfg(ENGINE_LM)
    L, vocab = cfg["num_layers"], cfg["vocab_size"]
    armed_per = 6 * L + 1
    tmp = tempfile.mkdtemp(prefix="aot_")
    try:
        cache = os.path.join(tmp, "cc")
        before = read_launches()
        parent, st, secs = aot_forward(cache, seed)
        stored = [f for f in os.listdir(cache) if f.endswith(".bin")]
        blob_mb = sum(os.path.getsize(os.path.join(cache, f))
                      for f in stored) / 1e6
        check(st == {"hits": 0, "misses": 1, "quarantined": 0,
                     "exports": 1} and len(stored) == 1 and
              f32_flash(read_launches()) - f32_flash(before) == L,
              "[aot] the storing run: %s, %d entries" % (st, len(stored)))
        out_path = os.path.join(tmp, "child.npy")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", "import chip_smoke; chip_smoke.aot_child"
             "(%r, %d, %r)" % (cache, seed, out_path)],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=AOT_CHILD_TIMEOUT_S)
        child_s = time.perf_counter() - t0
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("AOT_CHILD ")]
        check(proc.returncode == 0 and lines,
              "[aot] the child process failed (%d): %s"
              % (proc.returncode, proc.stderr[-3000:]))
        child = json.loads(lines[-1][len("AOT_CHILD "):])
        same = bool(np.array_equal(np.load(out_path), parent))
        check(child["hits"] == 1 and child["exports"] == 0 and
              child["misses"] == 0 and same,
              "[aot] the child: %s, logits bitwise equal %s"
              % (child, same))
        print("[aot] the LM's forward program (T %d, batch 1, %s): stored "
              "by this process's run (%.2f s: export, store, run; a %.2f "
              "MB entry); a child process loaded it: %s, its run %.2f s, "
              "%.2f s for the child in all (start, startup on the card, "
              "load, run); logits bitwise equal: %s; %s"
              % (ENGINE_T, cfg, secs, blob_mb, child, child["seconds"],
                 child_s, same, card))
        path = os.path.join(cache, stored[0])
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0xFF]))
        again, st2, secs2 = aot_forward(cache, seed)
        check(st2 == {"hits": 0, "misses": 1, "quarantined": 1,
                      "exports": 1} and np.array_equal(again, parent) and
              any(f.startswith("corrupt_") for f in os.listdir(cache)),
              "[aot] a flipped byte: %s" % st2)
        print("[aot] one byte of the stored blob flipped: the next fresh "
              "executor quarantined the entry and rebuilt it (%s, %.2f "
              "s), logits bitwise equal: True" % (st2, secs2))
        del parent, again
        shutil.rmtree(cache, ignore_errors=True)

        # -- the artifacts, with and without compiled/ ----------------------
        from paddle_tpu_torch import config
        d32, d8 = os.path.join(tmp, "f32"), os.path.join(tmp, "int8")
        config.set_flags(serving_quant_compute=True)
        try:
            t0 = time.perf_counter()
            secs, _ = uncounted(lambda: engine_export(
                ENGINE_LM, ENGINE_T, seed, "cuda", {d32: None, d8: "int8"},
                compiled=ENGINE_BUCKETS))
            export_s = time.perf_counter() - t0
        finally:
            config.set_flags(serving_quant_compute=False)
        torch.cuda.empty_cache()
        from paddle_tpu_torch.serving import deploy
        sizes = {}
        for d in (d32, d8):
            index = deploy.load_compiled_index(d)
            check(index is not None and sorted(map(int, index["buckets"]))
                  == sorted(ENGINE_BUCKETS),
                  "[aot] %s exported no compiled/ buckets" % d)
            sizes[d] = {b: e["nbytes"] for b, e in index["buckets"].items()}
        print("[aot] the [engine] artifacts exported with compiled/ "
              "buckets %s: f32 in %.2f s, int8 (serving_quant_compute) in "
              "%.2f s, %.2f s in all with the startup; bucket programs "
              "%s bytes; %s"
              % (ENGINE_BUCKETS, secs[d32], secs[d8], export_s, sizes, card))
        rows = rng.integers(2, vocab, (16, ENGINE_T)).astype(np.int32)
        kw = dict(buckets=ENGINE_BUCKETS, replicas=ENGINE_REPLICAS,
                  timeout=ENGINE_TIMEOUT_S)
        n_primed = len(ENGINE_BUCKETS) * ENGINE_REPLICAS
        out = {}
        for name, path, quant, per in (("f32", d32, False, (L, 0)),
                                       ("int8", d8, True, (L, armed_per))):
            res = {}
            for mode in ("plain", "compiled"):
                r = aot_engine(path, quant, dict(
                    kw, use_exported=mode == "compiled"), rows, d8)
                delta = dict(r["launches"])
                want = {"flash_attention": per[0] * r["executions"],
                        "int8_matmul": per[1] * r["executions"]}
                got = {"flash_attention": f32_flash(delta),
                       "int8_matmul": delta["int8_matmul"]}
                check(got == want and not any(
                    v for k, v in delta.items()
                    if k not in ("flash_attention", "int8_matmul")),
                    "[aot] %s %s engine: launches %s != %s for %d "
                    "executions" % (name, mode, delta, want,
                                    r["executions"]))
                check(r["fallbacks"] == 0 and r["loads"] == (
                    n_primed if mode == "compiled" else 0) and
                    r["primed"] == (n_primed if mode == "compiled" else 0)
                    and r["graphs"] == n_primed and r["recaptures"] ==
                    ENGINE_REPLICAS,
                    "[aot] %s %s engine: %d loads, %d fallbacks, %d primed "
                    "entries, %d graphs, %d recaptures after the swap"
                    % (name, mode, r["loads"], r["fallbacks"], r["primed"],
                       r["graphs"], r["recaptures"]))
                res.setdefault(mode, []).append(r)
            base = res["plain"][0]
            for mode, runs in res.items():
                for r in runs:
                    check(all(np.array_equal(r[k], base[k])
                              for k in ("first", "b8", "b1", "after")),
                          "[aot] %s %s engine's answers differ from the "
                          "plain artifact's" % (name, mode))
            for mode in ("plain", "compiled"):
                runs = res[mode]
                print("[aot] %s engine, %s artifact (%s; the plain one's "
                      "engine is built first): cold start (construction "
                      "+ warmup + first response) %s ms; construction + "
                      "warmup %s s; AOT loads %d, fallbacks %d; swap "
                      "blackout (the flip) %s ms, the first bucket-8 batch "
                      "after the swap (it recaptures) %s ms; batch time by "
                      "bucket (median, histogram mean, program with logits "
                      "on the card) %s; answers bitwise equal to the plain "
                      "artifact's engine: True; %s"
                      % (name, mode, "with compiled/" if mode == "compiled"
                         else "use_exported=False",
                         [round(r["cold_ms"], 1) for r in runs],
                         [round(r["build_s"], 2) for r in runs],
                         runs[0]["loads"], runs[0]["fallbacks"],
                         [round(r["blackout_ms"], 4) for r in runs],
                         [round(r["after_ms"], 2) for r in runs],
                         [{b: "%.2f ms (%.2f; %.2f)" % v
                           for b, v in r["times"].items()} for r in runs],
                         card))
            out[name] = {mode: dict(
                cold_ms=[r["cold_ms"] for r in runs],
                blackout_ms=[r["blackout_ms"] for r in runs],
                after_ms=[r["after_ms"] for r in runs],
                times=[r["times"] for r in runs])
                for mode, runs in res.items()}
            del res, base
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def phase_captures():
    """[captures]: every CUDA graph the run's executors captured, recaptured
    and replayed; no capture may have failed on any path."""
    from paddle_tpu_torch.core import executor
    totals = dict(executor.CAPTURES)
    print("[captures] the executors' CUDA graphs over the whole run: %s"
          % totals)
    check(totals.get("failed", 0) == 0 and totals.get("captures", 0) > 0,
          "[captures] %s" % totals)

def engine_resnet(seed, tmp, card):
    """ResNet-50 as bench.py builds it (fused_conv_bn on), its forward
    program (is_test) exported through io.save_inference_model. The
    export keeps Parameters only, as the reference's does, so the batch
    norms' running statistics are not in the artifact: the engine
    refuses it at warmup with the reference's error, before any kernel
    launches. Returns the line to print."""
    import os
    from paddle_tpu_torch import config, core, io, layers
    from paddle_tpu_torch.core.enforce import EnforceNotMet
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.serving import ServingEngine
    r = ENGINE_RESNET
    config.set_flags(fused_conv_bn=True)
    try:
        main, startup = core.Program(), core.Program()
        with core.unique_name.guard(), core.program_guard(main, startup):
            img = layers.data("img", shape=[3, r["res"], r["res"]])
            label = layers.data("label", shape=[1], dtype="int64")
            logits = resnet.resnet_imagenet(img, label, depth=r["depth"],
                                            class_dim=r["class_dim"],
                                            is_test=True)[2]
    finally:
        config.set_flags(fused_conv_bn=False)
    startup.random_seed = seed
    exe, scope = core.Executor(device="cuda"), core.Scope()
    uncounted(lambda: exe.run(startup, scope=scope))
    d = os.path.join(tmp, "resnet50")
    io.save_inference_model(d, ["img"], [logits], exe, main_program=main,
                            scope=scope)
    pruned = io.prune_program(main, [logits.name]).global_block()
    stats = sorted(n for n, v in pruned.vars.items() if v.persistable and
                   not isinstance(v, core.framework.Parameter))
    saved = len(io.load_params(d))
    del scope
    before = read_launches()
    err = None
    try:
        ServingEngine(d, buckets=ENGINE_BUCKETS, device="cuda").close()
    except EnforceNotMet as exc:
        err = str(exc)
    b1 = read_launches()["conv_bn_stats"] - before["conv_bn_stats"]
    check(err is not None and "is not initialized" in err and
          any(repr(n) in err for n in stats) and b1 == 0,
          "[engine] ResNet-50's artifact: %r, B1 %d" % (err, b1))
    return ("ResNet-50 (is_test, %d x %d, fused_conv_bn) exported with "
            "%d parameters and without its %d running statistics (the "
            "reference's save_inference_model keeps Parameters only); the "
            "engine refuses it at warmup as the reference does: %s; B1 "
            "launches %d; %s"
            % (r["res"], r["res"], saved, len(stats), err.split(" — ")[0],
               b1, card))

# -- the LeNet-5/MNIST slice: the op library and LeNet-5 training ----------

OPS_CARD_ULPS = 16          # transcendentals: CUDA's and the CPU's libm
OPS_SUM_RTOL = 2e-5         # reductions, products: another order
OPS_CONV_RTOL = 1e-4        # cuDNN's and the CPU's f32 convolutions
OPS_STEPS = 3               # update-rule steps chained card and CPU
LENET = dict(batch=64, lr=1e-3, compare_steps=5, train_steps=50,
             acc_window=10, acc_floor=0.9, windows=5, window_steps=10)
LENET_LOSS_RTOL = 1e-4      # 5 Adam steps, cuDNN against the CPU
LENET_RULES = 6             # Adam's updates: 2 convolutions, the fc


def ops_tolerance(case):
    """The card-against-CPU tolerance of an op case: bitwise where the
    port's compute is elementwise IEEE arithmetic or selection (the
    case's own tolerance 0), else a family bound on max|card - cpu| /
    max|cpu|."""
    from paddle_tpu_torch.probes import op_cases as oc
    if case.tol == oc.EXACT:
        return 0.0
    if case.tol == oc.ULP4:
        return OPS_CARD_ULPS * 2.0 ** -23
    if case.tol == oc.CONV:
        return OPS_CONV_RTOL
    return OPS_SUM_RTOL


def op_call(case, inputs, device, inplace=False):
    """A call of the port's op of ``case`` on ``inputs`` moved to
    ``device`` (moved now, so the call itself copies nothing from the
    host): returns {slot: [tensor]}, the outputs where the op put them.
    ``inplace``: the update rules' outputs name their inputs, and the
    executor's permission to write them in place is given."""
    import types
    import torch
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.probes import op_cases as oc
    op = oc.op_desc(case.op_type, inputs, case.attrs)
    if inplace:
        op.outputs = {oc.UPDATE_OUTPUTS[k]: [k] for k in inputs
                      if k in oc.UPDATE_OUTPUTS}
    vals = {k: [oc.to_torch(a, device) for a in
                (v if isinstance(v, list) else [v])]
            for k, v in inputs.items()}
    key = torch.tensor(oc.KEY_WORDS, dtype=torch.int64, device=device) \
        if case.key else None
    trace = types.SimpleNamespace(device=torch.device(device),
                                  inplace=inplace)
    compute = registry.get_op_def(case.op_type).compute

    def call():
        ctx = registry.ExecContext(op, vals, rng_key=key, trace=trace)
        with torch.no_grad():
            return registry.normalize_outputs(op, compute(ctx))
    return call


def op_err(card, cpu):
    """max|card - cpu| / max|cpu| over the finite elements, 0 where the
    two are equal (infinities included: a max pool over a window of
    padding is -inf in both packages); inf where only one is finite or
    integers differ."""
    import torch
    a = card.cpu()
    if torch.equal(a, cpu) or not cpu.numel():
        return 0.0
    if not cpu.is_floating_point():
        return float("inf")
    a, b = a.double(), cpu.double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    if not bool((torch.isfinite(a) & torch.isfinite(b) | same).all()):
        return float("inf")
    diff = torch.where(same, torch.zeros_like(a), a - b)
    finite = torch.where(torch.isfinite(b), b, torch.zeros_like(b))
    return float(diff.abs().max() / max(float(finite.abs().max()), 1e-30))


def phase_ops():
    """[ops]: every op type of the LeNet-5/MNIST slice on the card against
    the CPU on the same inputs (``probes/op_cases.py``'s cases): outputs
    on the card (no op falls back to the CPU), none reading back to the
    host on a warm second run (``torch.cuda`` sync debug mode "error",
    what a captured step needs), the update rules in place over 3
    steps, the random ops' threefry draws bitwise, ``auc``'s
    accumulated counts over 3 batches exact; the worst error per family
    against its tolerance."""
    import torch
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.probes import op_cases as oc
    t0 = time.perf_counter()
    worst = {}
    checked = set()
    for case in oc.CASES:
        inputs = case.inputs()
        family = oc.family(case.op_type)
        tol = ops_tolerance(case)
        rule = case.op_type in oc.UPDATE_RULES
        steps = OPS_STEPS if rule else 1
        state = {"cpu": dict(inputs), "cuda": dict(inputs)}
        rs = np.random.RandomState(5)
        for step in range(steps):
            if rule:
                grad = rs.standard_normal(
                    inputs["Grad"].shape).astype(np.float32)
                for d in state.values():
                    d["Grad"] = grad
            out = {dev: op_call(case, state[dev], dev, inplace=rule)()
                   for dev in ("cpu", "cuda")}
            if not rule:
                # a warm second call reads nothing back to the host
                again = op_call(case, state["cuda"], "cuda")
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    again()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            check(sorted(out["cuda"]) == sorted(out["cpu"]),
                  "[ops] %s: slots %s against %s" % (case.id,
                                                     sorted(out["cuda"]),
                                                     sorted(out["cpu"])))
            for slot, vals in out["cpu"].items():
                for got, want in zip(out["cuda"][slot], vals):
                    check(got.device.type == "cuda" and
                          got.dtype == want.dtype and
                          got.shape == want.shape,
                          "[ops] %s %s: %s %s %s against %s %s" % (
                              case.id, slot, got.device, got.dtype,
                              tuple(got.shape), want.dtype,
                              tuple(want.shape)))
                    err = op_err(got, want)
                    bound = tol * (step + 1)
                    check(err <= bound, "[ops] %s %s step %d: card against "
                          "CPU %.3g > %.3g" % (case.id, slot, step, err,
                                               bound))
                    ratio = err / bound if bound else 0.0
                    if ratio >= worst.get(family, (-1.0,))[0]:
                        worst[family] = (ratio, case.id, err, bound)
            if rule:
                for dev in ("cpu", "cuda"):
                    for k in list(state[dev]):
                        if k in oc.UPDATE_OUTPUTS:
                            state[dev][k] = out[dev][oc.UPDATE_OUTPUTS[k]][
                                0].cpu().numpy()
        checked.add(case.op_type)
    # auc's statistics accumulated over batches, as an evaluator sums them
    auc = next(c for c in oc.CASES if c.op_type == "auc")
    batches = [oc.Case("auc", auc.make, auc.attrs,
                       name="batch%d" % b).inputs() for b in range(3)]
    acc = {dev: sum(op_call(auc, inputs, dev)()["StatCounts"][0]
                    for inputs in batches) for dev in ("cpu", "cuda")}
    check(torch.equal(acc["cuda"].cpu(), acc["cpu"]) and
          float(acc["cpu"].sum()) == 3 * auc.attrs["num_thresholds"] *
          auc.inputs()["Out"].shape[0],
          "[ops] auc's accumulated counts differ card to CPU")
    slice_ops = set(oc.SLICE_OPS)
    check(slice_ops <= checked and len(slice_ops) == 118 and
          slice_ops <= set(registry.registered_ops()),
          "[ops] checked %d of the slice's %d op types"
          % (len(slice_ops & checked), len(slice_ops)))
    print("[ops] %d op types of the slice checked card against CPU (%d "
          "cases, the %d update rules over %d in-place steps, auc's counts "
          "over 3 batches exact), in %.1f s" % (
              len(slice_ops & checked), len(oc.CASES),
              len(oc.UPDATE_RULES), OPS_STEPS, time.perf_counter() - t0))
    for family in sorted(worst):
        _, case_id, err, bound = worst[family]
        print("[ops]   %-10s worst %-32s %.3g (tolerance %.3g)"
              % (family, case_id, err, bound))


def synth_digits(n, rs, img_shape=(1, 28, 28), n_classes=10):
    """The book test's synthetic digits (``tests/test_book_mnist.py``):
    noise with a class-dependent blob."""
    y = rs.randint(0, n_classes, size=n)
    x = rs.randn(n, *img_shape).astype("float32") * 0.3
    for i in range(n):
        c = y[i]
        r0, c0 = 2 + (c // 5) * 12, 2 + (c % 5) * 5
        x[i, 0, r0:r0 + 6, c0:c0 + 4] += 2.0
    return x, y.astype("int64").reshape(-1, 1)


def lenet_program(seed, lr, train=True):
    """LeNet-5 as ``models/lenet.py`` builds it, with ``Adam(lr)`` when
    ``train`` (without, the test program: the same parameter names)."""
    from paddle_tpu_torch import core, layers, optimizer
    from paddle_tpu_torch.models import lenet
    main, startup = core.Program(), core.Program()
    startup.random_seed = seed
    with core.unique_name.guard(), core.program_guard(main, startup):
        img = layers.data("img", shape=[1, 28, 28])
        label = layers.data("label", shape=[1], dtype="int64")
        loss, acc, logits = lenet.lenet5(img, label)
        if train:
            optimizer.Adam(learning_rate=lr).minimize(loss, startup)
    return main, startup, loss, acc, logits


def phase_lenet(seed):
    """[lenet]: LeNet-5 (BASELINE config 1 at its published widths:
    conv 20 and 50 filters 5x5, pools 2x2, fc 10; batch 64, 1x28x28,
    Adam(1e-3)) through ``Executor.run``: 5 steps on the card against
    the CPU from the same startup weights; 50 steps from the startup
    (the last 10's mean accuracy above 0.9, as the book test); the test
    program captured as a CUDA graph, its replay bitwise the eager run;
    the step time (median window of 10 steps closed by a synchronize),
    images/s, one step's busy share and the peak memory."""
    import torch
    from paddle_tpu_torch import core
    cfg = LENET
    t0 = time.perf_counter()
    main, startup, loss, acc, _ = lenet_program(seed, cfg["lr"])
    check(sum(op.type == "adam" for op in main.global_block().ops) ==
          LENET_RULES, "[lenet] the program has not LeNet-5's 6 updates")
    init = core.Scope()
    core.Executor(device="cpu").run(startup, scope=init)
    rs = np.random.RandomState(seed)
    batches = [synth_digits(cfg["batch"], rs)
               for _ in range(cfg["train_steps"])]
    feeds = [{"img": x, "label": y} for x, y in batches]
    losses = {}
    for dev in ("cpu", "cuda"):
        scope = scope_copy(init, dev)
        exe = core.Executor(device=dev)
        losses[dev] = [float(exe.run(main, feed=f, fetch_list=[loss],
                                     scope=scope)[0])
                       for f in feeds[:cfg["compare_steps"]]]
    err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                   losses["cpu"]))
    print("[lenet] %d Adam steps from the same startup weights, losses "
          "card %s cpu %s: rel err %.3g (tolerance %.0e)" % (
              cfg["compare_steps"], [round(v, 6) for v in losses["cuda"]],
              [round(v, 6) for v in losses["cpu"]], err, LENET_LOSS_RTOL))
    check(err <= LENET_LOSS_RTOL, "[lenet] card against CPU: %.3g" % err)
    # 50 steps on the card from the startup weights
    scope = scope_copy(init, "cuda")
    exe = core.Executor(device="cuda")
    accs = []
    for f in feeds:
        _, a = exe.run(main, feed=f, fetch_list=[loss, acc], scope=scope)
        accs.append(float(a))
    mean_acc = float(np.mean(accs[-cfg["acc_window"]:]))
    print("[lenet] %d steps on the card: mean accuracy over the last %d "
          "%.4f (floor %.1f)" % (cfg["train_steps"], cfg["acc_window"],
                                 mean_acc, cfg["acc_floor"]))
    check(mean_acc > cfg["acc_floor"], "[lenet] accuracy %.4f" % mean_acc)
    # timed steps: windows closed by a synchronize (bench.py's discipline)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases left allocated counts in the peak: print the
    # peak above it too
    base = torch.cuda.memory_allocated()
    feed = {k: torch.from_numpy(v).cuda() for k, v in feeds[0].items()}
    windows = []
    for _ in range(cfg["windows"]):
        t1 = time.perf_counter()
        for _ in range(cfg["window_steps"]):
            out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                           return_numpy=False)
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t1) * 1e3 /
                       cfg["window_steps"])
    step_ms = float(np.median(windows))
    peak = torch.cuda.max_memory_allocated()
    busy = profile_window("lenet one training step", lambda: exe.run(
        main, feed=feed, fetch_list=[loss], scope=scope,
        return_numpy=False))
    print("[lenet] step %.3f ms (median of %d windows of %d: %s), %.1f "
          "images/s, busy %s, peak allocated %.1f MB (%.1f MB above the "
          "%.1f MB allocated before the windows); %s" % (
              step_ms, cfg["windows"], cfg["window_steps"],
              [round(w, 3) for w in windows], cfg["batch"] / step_ms * 1e3,
              "not measured" if busy is None else
              "%.1f%%" % (100 * busy["busy_share"]), peak / 1e6,
              (peak - base) / 1e6, base / 1e6, card_line()))
    # the test program: its second run captures a CUDA graph, the third
    # replays it; the replay bitwise the eager first run
    test, _, _, _, logits = lenet_program(seed, cfg["lr"], train=False)
    texe = core.Executor(device="cuda")
    with deterministic_cudnn():
        outs = [texe.run(test, feed=feeds[1], fetch_list=[logits],
                         scope=scope, return_numpy=False)[0].clone()
                for _ in range(3)]
    stats = texe.capture_stats()
    print("[lenet] test program on the card: captures %s; replay against "
          "the eager run bitwise: %s" % (stats,
                                         torch.equal(outs[2], outs[0])))
    check(stats["captures"] == 1 and stats["failed"] == 0 and
          stats["replays"] >= 1 and torch.equal(outs[2], outs[0]),
          "[lenet] the test program's capture: %s" % stats)
    print("[lenet] done in %.1f s" % (time.perf_counter() - t0))
    return dict(step_ms=step_ms, peak=peak)


# -- the RNN and seq2seq slice: sequence, control-flow, beam-search, seq2seq,
# CRF/CTC and nested-sequence ops; BASELINE configs 3 and 4; uncached LM
# generation over B2 ------------------------------------------------------

OPS_RNN_RTOL = 1e-4         # time loops: products and transcendentals
#                             chained over the steps, cuBLAS against the CPU
RNN_LOSS_RTOL = 1e-4        # a few Adam steps of an RNN, card against CPU
SEQ2SEQ = dict(batch=128, src_len=50, trg_len=50, vocab=30000, emb=512,
               hid=512, lr=1e-3, warmup=3, steps=20, beam=4, gen_len=50,
               gen_runs=3)
SEQ2SEQ_SMALL = dict(batch=8, src_len=10, trg_len=10, vocab=500, emb=64,
                     hid=64, lr=1e-3, steps=5, beam=4, gen_len=12)
LSTM_SENT = dict(vocab=30000, emb=128, hid=512, layers=3, classes=2,
                 batch=128, max_len=100, min_len=50, lr=1e-3, warmup=10,
                 windows=5, window_steps=10)
LSTM_SMALL = dict(vocab=50, t=12, emb=16, hid=32, layers=2, batch=32,
                  lr=2e-3, compare_steps=5, train_steps=60, acc_window=10,
                  acc_floor=0.9)
LM_GENERATE = dict(vocab_size=1024, d_model=512, num_heads=8, d_ff=2048,
                   num_layers=4, max_len=64)
LM_GENERATE_BATCH = 8
LM_GENERATE_SAMPLE = dict(sample_seed=20260807, temperature=0.9, top_k=6)
LM_GENERATE_RUNS = 3
CF = dict(batch=4, t=5, d=3, h=6, lr=5e-3, steps=3)


def seq2seq_gflop(cfg):
    """The forward's products of ``seq2seq_attention`` in GFLOP (2 per
    multiply-add), from the code's shapes: the two encoder projections
    and GRUs, the encoder's output fc, and per decoder step the attention
    query, scores and context, the GRU's input and recurrent products and
    the vocabulary projection."""
    b, t, t2, v = cfg["batch"], cfg["src_len"], cfg["trg_len"], cfg["vocab"]
    e, h = cfg["emb"], cfg["hid"]
    enc = 2 * (2 * b * t * e * 3 * h) + 2 * t * (2 * b * h * 3 * h) + \
        2 * b * t * 2 * h * h
    dec = t2 * (2 * b * h * h + 2 * 2 * b * t * h +
                2 * b * (e + h) * 3 * h + 2 * b * h * 3 * h + 2 * b * h * v)
    return (enc + dec) / 1e9, t2 * 2 * b * h * v / 1e9


def lstm_sentiment_gflop(cfg):
    """The forward's products of ``stacked_lstm_net`` in GFLOP: the first
    fc, each LSTM's recurrent product per step, each later fc over the
    [fc, lstm] pair, the classifier."""
    n, t = cfg["batch"], cfg["max_len"]
    e, h = cfg["emb"], cfg["hid"]
    first = 2 * n * t * e * 4 * h
    rec = cfg["layers"] * t * 2 * n * h * 4 * h
    later = (cfg["layers"] - 1) * 2 * n * t * (4 * h + h) * 4 * h
    return (first + rec + later + 2 * n * 5 * h * cfg["classes"]) / 1e9


def cf_program(kind, train=False, seed=0):
    """The control-flow programs of ``[ops]`` and ``[control-flow]``, the
    reference's tests' own (``tests/test_control_flow.py``): ``while``,
    an fc RNN under ``While(max_iters)``; ``static_rnn``, an LSTM step
    (``lstm_unit``) under ``StaticRNN``; ``unbounded``, a loop whose trip
    count is the feed ``n``; ``cond``, two branches over one weight.
    Returns (main, startup, fetch list, feed)."""
    from paddle_tpu_torch import core, layers as L, optimizer
    c = CF
    rs = np.random.RandomState(seed + 31)
    x = rs.randn(c["batch"], c["t"], c["d"]).astype(np.float32)
    feed = {"x": x, "y": x.sum(axis=(1, 2)).reshape(-1, 1) * 0.1}
    main, startup = core.Program(), core.Program()
    startup.random_seed = seed + 6
    with core.unique_name.guard(), core.program_guard(main, startup):
        xv = L.data("x", shape=[c["t"], c["d"]])
        yv = L.data("y", shape=[1])
        if kind == "while":
            xt = L.transpose(xv, perm=[1, 0, 2])
            i = L.fill_constant([1], "int32", 0)
            n = L.fill_constant([1], "int32", c["t"])
            h = L.fill_constant_batch_size_like(
                xv, shape=[-1, c["h"]], dtype="float32", value=0.0)
            cond_v = L.less_than(i, n)
            w = L.While(cond_v, max_iters=c["t"])
            with w.block():
                x_t = L.reshape(L.gather(xt, i), [-1, c["d"]])
                L.assign(L.fc([x_t, h], c["h"], act="tanh"), h)
                L.assign(L.increment(i, 1, in_place=False), i)
                L.assign(L.less_than(i, n), cond_v)
            out = h
        elif kind == "static_rnn":
            zero = L.fill_constant_batch_size_like(
                xv, shape=[-1, c["h"]], dtype="float32", value=0.0)
            rnn = L.StaticRNN()
            with rnn.step():
                x_t = rnn.step_input(xv)
                h_prev = rnn.memory(init=zero)
                c_prev = rnn.memory(init=zero)
                h, cell = L.lstm_unit(x_t, h_prev, c_prev, forget_bias=1.0)
                rnn.update_memory(h_prev, h)
                rnn.update_memory(c_prev, cell)
                rnn.step_output(h)
            out = L.sequence_pool(rnn(), "last")
        elif kind == "unbounded":
            n = L.data("n", shape=[1], dtype="int32",
                       append_batch_size=False)
            feed["n"] = np.array([4], np.int32)
            i = L.fill_constant([1], "int32", 0)
            acc = L.fill_constant_batch_size_like(
                xv, shape=[-1, c["d"]], dtype="float32", value=0.0)
            cond_v = L.less_than(i, n)
            w = L.While(cond_v)
            with w.block():
                step = L.reshape(L.gather(L.transpose(xv, perm=[1, 0, 2]),
                                          i), [-1, c["d"]])
                L.assign(L.elementwise_add(L.scale(acc, 0.5), step), acc)
                L.assign(L.increment(i, 1, in_place=False), i)
                L.assign(L.less_than(i, n), cond_v)
            out = acc
        else:
            flag = L.data("flag", shape=[], dtype="bool",
                          append_batch_size=False)
            feed["flag"] = np.array(True)
            flat = L.reshape(xv, [-1, c["t"] * c["d"]])
            w = main.global_block().create_parameter(
                name="cf_cond_w", shape=[c["t"] * c["d"], 2],
                dtype="float32")
            sv = startup.global_block().create_var(
                name="cf_cond_w", shape=[c["t"] * c["d"], 2],
                dtype="float32", persistable=True)
            from paddle_tpu_torch.initializer import NormalInitializer
            NormalInitializer(0.0, 0.1)(sv, startup.global_block())
            out = L.cond(flag, lambda: L.tanh(L.mul(flat, w)),
                         lambda: L.scale(L.mul(flat, w), 3.0))
        loss = L.mean(L.square_error_cost(L.fc(out, 1), yv))
        if train:
            optimizer.Adam(learning_rate=c["lr"]).minimize(loss, startup)
    return main, startup, [out, loss], feed


def gru_beam_program(beam, seed=0):
    """A GRU step (embedding, fc, gru_unit, fc to 11 tokens) under
    ``BeamSearchDecoder``: (main, startup, [ids, lengths, scores], feed)."""
    from paddle_tpu_torch import core, layers as L
    main, startup = core.Program(), core.Program()
    startup.random_seed = seed + 4
    with core.unique_name.guard(), core.program_guard(main, startup):
        h0 = L.data("h0", shape=[6])
        bs = L.BeamSearchDecoder(beam_size=beam, max_len=5, bos_id=0,
                                 eos_id=1)
        with bs.step():
            tok = bs.token()
            h_prev = bs.state(h0)
            emb = L.embedding(tok, size=[11, 6], param_attr="gd.emb")
            h, _, _ = L.gru_unit(L.fc(emb, 18, param_attr="gd.proj"),
                                 h_prev, 6, param_attr="gd.w",
                                 bias_attr="gd.b")
            bs.update_state(h_prev, h)
            bs.set_logits(L.fc(h, 11, param_attr="gd.out"))
        outs = bs(return_all_beams=True)
    feed = {"h0": np.random.RandomState(seed + 2).randn(3, 6)
            .astype(np.float32)}
    return main, startup, list(outs), feed


def cuda_feed(feed):
    import torch
    return {k: torch.from_numpy(np.asarray(v)).cuda() for k, v in
            feed.items()}


def program_pair(main, startup, fetch, feed):
    """The fetches of one run of ``main`` on the CPU and on the card from
    the same startup weights (drawn on the CPU)."""
    from paddle_tpu_torch import core
    init = core.Scope()
    core.Executor(device="cpu").run(startup, scope=init)
    cpu = core.Executor(device="cpu").run(main, feed=feed, fetch_list=fetch,
                                          scope=scope_copy(init, "cpu"))
    scope = scope_copy(init, "cuda")
    card = core.Executor(device="cuda").run(main, feed=feed,
                                            fetch_list=fetch, scope=scope)
    return card, cpu, init


def phase_ops_rnn(seed):
    """[ops] of the RNN and seq2seq slice: its 31 op types outside
    sub-blocks on the card against the CPU on ``probes/op_cases.py``'s
    cases, a warm second call reading nothing back to the host; and the
    4 sub-block op types (``static_rnn``, bounded ``while``,
    ``dynamic_beam_search``; unbounded ``while`` and ``cond``) through
    small programs: card against CPU, the warm run of the first three
    with the sync debug mode at "error", the host reads of the last two
    counted (one before each iteration and one that stops the loop; one
    a ``cond``)."""
    import torch
    from paddle_tpu_torch import core
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.ops import control_flow_ops as cf
    from paddle_tpu_torch.probes import op_cases as oc
    t0 = time.perf_counter()
    worst, checked = {}, set()
    for case in oc.RNN_CASES:
        inputs = case.inputs()
        family = oc.rnn_family(case.op_type)
        tol = OPS_RNN_RTOL if case.tol == oc.RNN else ops_tolerance(case)
        out = {dev: op_call(case, inputs, dev)() for dev in ("cpu", "cuda")}
        again = op_call(case, inputs, "cuda")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            again()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(sorted(out["cuda"]) == sorted(out["cpu"]),
              "[ops] %s: slots differ" % case.id)
        for slot, vals in out["cpu"].items():
            for got, want in zip(out["cuda"][slot], vals):
                check(got.device.type == "cuda" and got.dtype == want.dtype
                      and got.shape == want.shape,
                      "[ops] %s %s: %s %s %s against %s %s" % (
                          case.id, slot, got.device, got.dtype,
                          tuple(got.shape), want.dtype, tuple(want.shape)))
                err = op_err(got, want)
                check(err <= tol, "[ops] %s %s: card against CPU %.3g > "
                      "%.3g" % (case.id, slot, err, tol))
                ratio = err / tol if tol else 0.0
                if ratio >= worst.get(family, (-1.0,))[0]:
                    worst[family] = (ratio, case.id, err, tol)
        checked.add(case.op_type)
    reads = {}
    for kind, build in (("static_rnn", lambda: cf_program("static_rnn")),
                        ("while", lambda: cf_program("while")),
                        ("dynamic_beam_search",
                         lambda: gru_beam_program(3, seed)),
                        ("unbounded while", lambda: cf_program("unbounded")),
                        ("cond", lambda: cf_program("cond"))):
        main, startup, fetch, feed = build()
        before = dict(cf.HOST_READS)
        card, cpu, init = program_pair(main, startup, fetch, feed)
        for got, want in zip(card, cpu):
            if np.issubdtype(want.dtype, np.floating):
                err = float(np.abs(got.astype(np.float64) - want).max() /
                            max(float(np.abs(want).max()), 1e-30))
            else:
                err = 0.0 if np.array_equal(got, want) else float("inf")
            check(err <= OPS_RNN_RTOL, "[ops] %s: card against CPU %.3g"
                  % (kind, err))
            worst.setdefault("blocks", (0.0, kind, 0.0, OPS_RNN_RTOL))
            if err / OPS_RNN_RTOL >= worst["blocks"][0]:
                worst["blocks"] = (err / OPS_RNN_RTOL, kind, err,
                                   OPS_RNN_RTOL)
        reads[kind] = {k: cf.HOST_READS[k] - before.get(k, 0)
                       for k in ("while", "cond")}
        if kind in ("unbounded while", "cond"):
            continue
        # a warm run op by op (a fresh executor's first) reads nothing back
        scope = scope_copy(init, "cuda")
        fresh = core.Executor(device="cuda")
        dev_feed = cuda_feed(feed)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fresh.run(main, feed=dev_feed, fetch_list=fetch, scope=scope,
                      return_numpy=False)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        checked.add(kind)
    check(reads["unbounded while"] == {"while": 2 * 5, "cond": 0} and
          reads["cond"] == {"while": 0, "cond": 2} and
          all(not any(reads[k].values()) for k in
              ("static_rnn", "while", "dynamic_beam_search")),
          "[ops] host reads of the control flow: %s" % reads)
    checked.add("cond")
    rnn_ops = set(oc.RNN_OPS)
    # 219 since the op tail (202 since the distribution slice, whose
    # three sparse and distributed lookup types run card against CPU in
    # [recsys]); the op tail's 17 are checked in its own [ops] call
    check(rnn_ops <= checked and len(rnn_ops) == 35 and
          rnn_ops <= set(registry.registered_ops()) and
          len(registry.registered_ops()) == 219,
          "[ops] checked %d of the RNN slice's %d op types; %d registered"
          % (len(rnn_ops & checked), len(rnn_ops),
             len(registry.registered_ops())))
    print("[ops] %d op types of the RNN and seq2seq slice checked card "
          "against CPU (%d cases and 5 programs; host reads, card and CPU "
          "runs together: %s), %d of the reference's 219 op types "
          "registered, in %.1f s" % (
              len(rnn_ops & checked), len(oc.RNN_CASES), reads,
              len(registry.registered_ops()), time.perf_counter() - t0))
    for family in sorted(worst):
        _, case_id, err, bound = worst[family]
        print("[ops]   %-10s worst %-32s %.3g (tolerance %.3g)"
              % (family, case_id, err, bound))


def rnn_train_pair(main, startup, loss, feeds):
    """Losses of Adam steps over ``feeds`` on the CPU and on the card from
    the same startup weights (drawn on the CPU), their worst relative
    difference, and the trained scopes by device."""
    from paddle_tpu_torch import core
    init = core.Scope()
    core.Executor(device="cpu").run(startup, scope=init)
    losses, scopes = {}, {}
    for dev in ("cpu", "cuda"):
        exe, scopes[dev] = core.Executor(device=dev), scope_copy(init, dev)
        losses[dev] = [float(exe.run(main, feed=f, fetch_list=[loss],
                                     scope=scopes[dev])[0]) for f in feeds]
    err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                   losses["cpu"]))
    return losses, err, scopes


def phase_control_flow(seed):
    """[control-flow]: a While(max_iters) fc RNN and a StaticRNN LSTM train
    3 Adam steps on the card against the CPU; their forward programs
    capture at their second run and replay bitwise the eager run; an
    unbounded While and a cond run op by op, are refused capture with the
    reason in ``capture_stats()``, and equal the CPU."""
    import torch
    from paddle_tpu_torch import core
    from paddle_tpu_torch.ops import control_flow_ops as cf
    t0 = time.perf_counter()
    c = CF
    rs = np.random.RandomState(seed + 32)
    feeds = []
    for _ in range(c["steps"]):
        x = rs.randn(c["batch"], c["t"], c["d"]).astype(np.float32)
        feeds.append({"x": x, "y": x.sum(axis=(1, 2)).reshape(-1, 1) * 0.1})
    for kind in ("while", "static_rnn"):
        main, startup, (_, loss), _ = cf_program(kind, train=True,
                                                 seed=seed)
        losses, err, _ = rnn_train_pair(main, startup, loss, feeds)
        print("[control-flow] %s: %d Adam steps, losses card %s cpu %s, "
              "rel err %.3g (tolerance %.0e)" % (
                  kind, c["steps"], [round(v, 6) for v in losses["cuda"]],
                  [round(v, 6) for v in losses["cpu"]], err,
                  RNN_LOSS_RTOL))
        check(err <= RNN_LOSS_RTOL, "[control-flow] %s: %.3g" % (kind, err))
    for kind in ("while", "static_rnn", "unbounded", "cond"):
        main, startup, fetch, feed = cf_program(kind, seed=seed)
        init = core.Scope()
        core.Executor(device="cpu").run(startup, scope=init)
        want = core.Executor(device="cpu").run(
            main, feed=feed, fetch_list=fetch, scope=scope_copy(init, "cpu"))
        exe, scope = core.Executor(device="cuda"), scope_copy(init, "cuda")
        dev_feed = cuda_feed(feed)
        before = dict(cf.HOST_READS)
        outs = [[v.clone() for v in exe.run(
            main, feed=dev_feed, fetch_list=fetch, scope=scope,
            return_numpy=False)] for _ in range(3)]
        reads = {k: cf.HOST_READS[k] - before.get(k, 0)
                 for k in ("while", "cond")}
        stats = exe.capture_stats()
        bitwise = all(torch.equal(a, b) for run in outs[1:]
                      for a, b in zip(run, outs[0]))
        err = max(float(np.abs(a.cpu().numpy().astype(np.float64) - b).max()
                        / max(float(np.abs(b).max()), 1e-30))
                  for a, b in zip(outs[0], want))
        print("[control-flow] %s forward, 3 runs on the card: %s; runs 2-3 "
              "bitwise run 1: %s; card against CPU %.3g; host reads %s"
              % (kind, stats, bitwise, err, reads))
        check(bitwise and err <= OPS_RNN_RTOL and stats["failed"] == 0,
              "[control-flow] %s: %s" % (kind, stats))
        if kind in ("while", "static_rnn"):
            check(stats["captures"] == 1 and stats["replays"] == 2 and
                  stats["refused"] == 0 and not any(reads.values()),
                  "[control-flow] %s did not capture: %s" % (kind, stats))
        else:
            check(stats["captures"] == 0 and stats["refused"] == 1 and
                  len(stats["refused_reasons"]) == 1 and
                  reads == ({"while": 3 * 5, "cond": 0}
                            if kind == "unbounded" else
                            {"while": 0, "cond": 3}),
                  "[control-flow] %s was not refused: %s %s"
                  % (kind, stats, reads))
    print("[control-flow] done in %.1f s" % (time.perf_counter() - t0))


def seq2seq_program(cfg, mode="train", beam_size=4):
    """``bench_seq2seq``'s program (``bench.py``): the reference's
    feeds, ``seq2seq_attention`` at ``cfg``'s widths, Adam(lr) for
    training; greedy or beam generation otherwise, reading the same
    parameter names. Returns (main, startup, outputs)."""
    from paddle_tpu_torch import core, layers, optimizer
    from paddle_tpu_torch.models.seq2seq import seq2seq_attention
    main, startup = core.Program(), core.Program()
    with core.unique_name.guard(), core.program_guard(main, startup):
        src = layers.data("src", shape=[cfg["src_len"]], dtype="int64")
        slen = layers.data("src_len", shape=[], dtype="int64")
        trg = layers.data("trg", shape=[cfg["trg_len"]], dtype="int64")
        tlen = layers.data("trg_len", shape=[], dtype="int64")
        lbl = layers.data("lbl", shape=[cfg["trg_len"]], dtype="int64")
        outs = seq2seq_attention(
            src, slen, trg, tlen, lbl, src_vocab=cfg["vocab"],
            trg_vocab=cfg["vocab"], emb_dim=cfg["emb"], hid_dim=cfg["hid"],
            mode=mode, max_gen_len=cfg["gen_len"], beam_size=beam_size)
        if mode == "train":
            optimizer.Adam(learning_rate=cfg["lr"]).minimize(outs[0],
                                                             startup)
    return main, startup, outs


def seq2seq_feed(cfg, rs):
    """bench.py's feeds: ids from 2 to the vocabulary, full lengths."""
    b = cfg["batch"]

    def ids(t):
        return rs.randint(2, cfg["vocab"], (b, t)).astype(np.int32)
    return {"src": ids(cfg["src_len"]), "trg": ids(cfg["trg_len"]),
            "lbl": ids(cfg["trg_len"]),
            "src_len": np.full((b,), cfg["src_len"], np.int32),
            "trg_len": np.full((b,), cfg["trg_len"], np.int32)}


def generation_times(main, feed, fetch, scope, runs):
    """(eager ms, replayed ms, the eager outputs, the replays bitwise
    equal to them): the first run of a fresh executor on the card (op by
    op), then the median of ``runs`` runs after its second, which
    captured the step."""
    import torch
    from paddle_tpu_torch import core
    exe = core.Executor(device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = [v.clone() for v in exe.run(main, feed=feed, fetch_list=fetch,
                                        scope=scope, return_numpy=False)]
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3
    exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
            return_numpy=False)
    times, same = [], True
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                       return_numpy=False)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        same = same and all(torch.equal(a, b) for a, b in zip(outs, eager))
    stats = exe.capture_stats()
    check(stats["captures"] == 1 and stats["failed"] == 0,
          "generation step not captured: %s" % stats)
    exe.release_graphs()
    return eager_ms, float(np.median(times)), eager, same


def phase_seq2seq_small(seed):
    """At a small width: 5 Adam steps on the card against the CPU from
    the same startup, and greedy and beam decoding of the trained CPU
    scope card against CPU (tokens equal)."""
    from paddle_tpu_torch import core
    cfg = SEQ2SEQ_SMALL
    main, startup, (loss, _) = seq2seq_program(cfg)
    rs = np.random.RandomState(seed + 40)
    feeds = [seq2seq_feed(cfg, rs) for _ in range(cfg["steps"])]
    for f in feeds:
        f["src_len"] = rs.randint(1, cfg["src_len"] + 1,
                                  cfg["batch"]).astype(np.int32)
        f["trg_len"] = rs.randint(1, cfg["trg_len"] + 1,
                                  cfg["batch"]).astype(np.int32)
    losses, err, scopes = rnn_train_pair(main, startup, loss, feeds)
    print("[seq2seq] small (batch %d, T %d, vocab %d, width %d): %d Adam "
          "steps card %s cpu %s, rel err %.3g (tolerance %.0e)" % (
              cfg["batch"], cfg["src_len"], cfg["vocab"], cfg["hid"],
              cfg["steps"], [round(v, 6) for v in losses["cuda"]],
              [round(v, 6) for v in losses["cpu"]], err, RNN_LOSS_RTOL))
    check(err <= RNN_LOSS_RTOL, "[seq2seq] small card against CPU %.3g"
          % err)
    feed = {k: feeds[0][k] for k in ("src", "src_len")}
    for mode in ("greedy", "beam"):
        gmain, _, gouts = seq2seq_program(cfg, mode, cfg["beam"])
        got = core.Executor(device="cuda").run(
            gmain, feed=feed, fetch_list=list(gouts),
            scope=scope_copy(scopes["cpu"], "cuda"))
        want = core.Executor(device="cpu").run(
            gmain, feed=feed, fetch_list=list(gouts), scope=scopes["cpu"])
        same = all(np.array_equal(a, b) for a, b in zip(got, want))
        print("[seq2seq] small %s decoding of the CPU-trained scope, card "
              "against CPU: tokens and lengths equal %s" % (mode, same))
        check(same, "[seq2seq] small %s tokens differ card to CPU" % mode)


def phase_seq2seq(seed):
    """[seq2seq]: ``bench_seq2seq``'s accelerator recipe (``bench.py``:
    batch 128, source and target length 50, vocabulary 30000, embedding
    and hidden 512, Adam(1e-3), feeds from RandomState(0)): 3 warm-up
    steps, 20 timed closed by one read of the loss,
    ``seq2seq_train_tokens_per_sec``, ms a step, one profiled step's busy
    share, the peak; then greedy and beam (4) generation of the 128
    sources, 50 tokens, from the trained scope: eager and replayed ms a
    batch, beam width 1 equal to greedy, replays bitwise the eager run;
    and the small width card against CPU."""
    import torch
    from paddle_tpu_torch import core
    cfg = SEQ2SEQ
    t0 = time.perf_counter()
    phase_seq2seq_small(seed)
    fwd_gflop, proj_gflop = seq2seq_gflop(cfg)
    main, startup, (loss, _) = seq2seq_program(cfg)
    exe, scope = core.Executor(device="cuda"), core.Scope()
    exe.run(startup, scope=scope)
    feed = cuda_feed(seq2seq_feed(cfg, np.random.RandomState(0)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for _ in range(cfg["warmup"]):
        outs = exe.run(main, feed=feed, fetch_list=[loss],
                       return_numpy=False, scope=scope)
    first = float(outs[0])
    t1 = time.perf_counter()
    for _ in range(cfg["steps"]):
        outs = exe.run(main, feed=feed, fetch_list=[loss],
                       return_numpy=False, scope=scope)
    final = float(outs[0])
    dt = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    tok_s = cfg["batch"] * cfg["trg_len"] * cfg["steps"] / dt
    step_ms = dt / cfg["steps"] * 1e3
    busy = profile_window("seq2seq one training step", lambda: exe.run(
        main, feed=feed, fetch_list=[loss], return_numpy=False,
        scope=scope))
    print("[seq2seq] seq2seq_train_tokens_per_sec %.1f (batch %d x %d "
          "target tokens x %d steps in %.3f s), %.3f ms a step, loss %.6f "
          "after the warm-up and %.6f after the timed steps, busy %s, peak "
          "allocated %.2f GB (%.2f GB above the %.2f GB allocated before); "
          "the forward's products %.1f GFLOP (%.1f of them the vocabulary "
          "projection), a step ~%.1f GFLOP: %.1f TFLOP/s; %s" % (
              tok_s, cfg["batch"], cfg["trg_len"], cfg["steps"], dt,
              step_ms, first, final, "not measured" if busy is None else
              "%.1f%%" % (100 * busy["busy_share"]), peak / 1e9,
              (peak - base) / 1e9, base / 1e9, fwd_gflop, proj_gflop,
              3 * fwd_gflop, 3 * fwd_gflop / step_ms, card_line()))
    check(np.isfinite(final) and final < first,
          "[seq2seq] the loss did not fall: %s -> %s" % (first, final))
    gfeed = {k: feed[k] for k in ("src", "src_len")}
    res = {}
    for mode, beam in (("greedy", 1), ("beam", cfg["beam"]), ("beam", 1)):
        gmain, _, gouts = seq2seq_program(cfg, mode, beam)
        eager_ms, replay_ms, outs, same = generation_times(
            gmain, gfeed, list(gouts), scope, cfg["gen_runs"])
        res[(mode, beam)] = outs
        lengths = outs[1].float()
        print("[seq2seq] %s%s generation, batch %d, %d tokens: eager %.3f "
              "ms, replayed %.3f ms a batch (median of %d); replays bitwise "
              "the eager run: %s; mean length %.2f; %s" % (
                  mode, "" if mode == "greedy" else " %d" % beam,
                  cfg["batch"], cfg["gen_len"], eager_ms, replay_ms,
                  cfg["gen_runs"], same, float(lengths.mean()),
                  card_line()))
        check(same, "[seq2seq] %s replay differs from the eager run" % mode)
    same = torch.equal(res[("beam", 1)][0], res[("greedy", 1)][0])
    print("[seq2seq] beam width 1 gives the greedy tokens: %s" % same)
    check(same, "[seq2seq] beam width 1 differs from greedy")
    del exe, scope
    print("[seq2seq] done in %.1f s" % (time.perf_counter() - t0))
    return dict(tok_s=tok_s, step_ms=step_ms)


def lstm_program(cfg, t, seed=0):
    """``stacked_lstm_net`` at ``cfg``'s widths with Adam: (main, startup,
    loss, acc)."""
    from paddle_tpu_torch import core, layers, optimizer
    from paddle_tpu_torch.models.lstm_sentiment import stacked_lstm_net
    main, startup = core.Program(), core.Program()
    startup.random_seed = seed + 5
    with core.unique_name.guard(), core.program_guard(main, startup):
        data = layers.data("words", shape=[t], dtype="int64")
        length = layers.data("length", shape=[], dtype="int64")
        label = layers.data("label", shape=[1], dtype="int64")
        loss, acc, _ = stacked_lstm_net(
            data, length, label, dict_dim=cfg["vocab"], emb_dim=cfg["emb"],
            hid_dim=cfg["hid"], stacked_num=cfg["layers"],
            class_dim=cfg.get("classes", 2))
        optimizer.Adam(learning_rate=cfg["lr"]).minimize(loss, startup)
    return main, startup, loss, acc


def synth_sentiment(n, t, vocab, rs):
    """The reference's synthetic sentiment task (``tests/test_models.py``):
    positive sequences hold a run of token 5."""
    y = rs.randint(0, 2, n)
    x = rs.randint(10, vocab, (n, t))
    length = rs.randint(t // 2, t + 1, n)
    for i in range(n):
        if y[i]:
            pos = rs.randint(0, length[i] - 1)
            x[i, pos:pos + 2] = 5
        x[i, length[i]:] = 0
    return {"words": x.astype(np.int32), "length": length.astype(np.int32),
            "label": y.astype(np.int32).reshape(-1, 1)}


def phase_lstm_sentiment(seed):
    """[lstm-sentiment]: ``stacked_lstm_net`` (BASELINE config 3) at the
    model's defaults (embedding 128, hidden 512, 3 layers, 2 classes),
    vocabulary 30000, batch 128, padded length 100, lengths uniform in
    [50, 100] from the seed (the IMDB RNN recipe of the reference's
    ``benchmark/paddle/rnn``), Adam(1e-3): 10 warm-up steps, then 5
    windows of 10 closed by a synchronize: ms a step, sequences/s, one
    step's busy share, the peak. At a small width: 5 steps card against
    CPU, and the reference's synthetic task learned above 0.9 accuracy
    over the last 10 of 60 steps on the card."""
    import torch
    from paddle_tpu_torch import core
    t0 = time.perf_counter()
    small = LSTM_SMALL
    main, startup, loss, acc = lstm_program(small, small["t"], seed)
    rs = np.random.RandomState(seed + 50)
    feeds = [synth_sentiment(small["batch"], small["t"], small["vocab"], rs)
             for _ in range(small["train_steps"])]
    losses, err, _ = rnn_train_pair(main, startup, loss,
                                    feeds[:small["compare_steps"]])
    print("[lstm-sentiment] small (vocab %d, T %d, width %d, %d layers): "
          "%d Adam steps card %s cpu %s, rel err %.3g (tolerance %.0e)" % (
              small["vocab"], small["t"], small["hid"], small["layers"],
              small["compare_steps"], [round(v, 6) for v in losses["cuda"]],
              [round(v, 6) for v in losses["cpu"]], err, RNN_LOSS_RTOL))
    check(err <= RNN_LOSS_RTOL, "[lstm-sentiment] small: %.3g" % err)
    exe, scope = core.Executor(device="cuda"), core.Scope()
    exe.run(startup, scope=scope)
    accs = [float(exe.run(main, feed=f, fetch_list=[loss, acc],
                          scope=scope)[1]) for f in feeds]
    mean_acc = float(np.mean(accs[-small["acc_window"]:]))
    print("[lstm-sentiment] the synthetic task on the card: mean accuracy "
          "over the last %d of %d steps %.4f (floor %.1f)" % (
              small["acc_window"], small["train_steps"], mean_acc,
              small["acc_floor"]))
    check(mean_acc > small["acc_floor"], "[lstm-sentiment] accuracy %.4f"
          % mean_acc)
    cfg = LSTM_SENT
    main, startup, loss, acc = lstm_program(cfg, cfg["max_len"], seed)
    exe, scope = core.Executor(device="cuda"), core.Scope()
    exe.run(startup, scope=scope)
    rs = np.random.RandomState(seed + 51)
    n, t = cfg["batch"], cfg["max_len"]
    length = rs.randint(cfg["min_len"], t + 1, n)
    words = rs.randint(2, cfg["vocab"], (n, t))
    words[np.arange(t)[None, :] >= length[:, None]] = 0
    feed = cuda_feed({"words": words.astype(np.int32),
                      "length": length.astype(np.int32),
                      "label": rs.randint(0, 2, (n, 1)).astype(np.int32)})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for _ in range(cfg["warmup"]):
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)
    first = float(out)
    windows = []
    for _ in range(cfg["windows"]):
        t1 = time.perf_counter()
        for _ in range(cfg["window_steps"]):
            out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                           return_numpy=False)
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t1) * 1e3 /
                       cfg["window_steps"])
    final = float(out)
    peak = torch.cuda.max_memory_allocated()
    step_ms = float(np.median(windows))
    busy = profile_window("lstm-sentiment one training step",
                          lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                          scope=scope, return_numpy=False))
    gflop = lstm_sentiment_gflop(cfg)
    print("[lstm-sentiment] batch %d x T %d (lengths %d-%d), vocab %d, "
          "embedding %d, hidden %d, %d layers: step %.3f ms (median of %d "
          "windows of %d: %s), %.1f sequences/s, loss %.6f -> %.6f, busy "
          "%s, peak allocated %.2f GB (%.2f GB above the %.2f GB before); "
          "the forward's products %.1f GFLOP, a step ~%.1f GFLOP: %.1f "
          "TFLOP/s; %s" % (
              n, t, length.min(), length.max(), cfg["vocab"], cfg["emb"],
              cfg["hid"], cfg["layers"], step_ms, cfg["windows"],
              cfg["window_steps"], [round(w, 3) for w in windows],
              n / step_ms * 1e3, first, final, "not measured" if busy is
              None else "%.1f%%" % (100 * busy["busy_share"]), peak / 1e9,
              (peak - base) / 1e9, base / 1e9, gflop, 3 * gflop,
              3 * gflop / step_ms, card_line()))
    check(np.isfinite(final), "[lstm-sentiment] loss %s" % final)
    print("[lstm-sentiment] done in %.1f s" % (time.perf_counter() - t0))
    return dict(step_ms=step_ms)


# -- the v2 API: the benchmark's IMDB recipe and the book's MNIST conv net
# written in paddle.v2, through SGD.train, SGD.test, infer and the tar ----

V2_LOSS_RTOL = 1e-4         # a few SGD steps of a v2 script, card against
#                             CPU from one tar (RNN_LOSS_RTOL's reasoning)
V2_INFER_ATOL = 1e-4        # the trained IMDB net's class probabilities,
#                             card against a CPU build of the topology
V2_MNIST = dict(batch=64, lr=0.01, momentum=0.9, steps=30, compare_steps=3,
                window=5, fall=0.5)
V2_IMDB_POOL = 4            # distinct batches the timed reader cycles
V2_INFER_ROWS = 16          # held-out samples through paddle.infer


def v2_imdb_net(paddle, cfg):
    """The IMDB recipe of ``benchmark/paddle/rnn`` in v2 layers only: an
    embedding, then ``layers`` pairs of fc (4 x hidden, linear) and
    lstmemory (hidden) whose direction alternates as in
    ``stacked_lstm_net``, each later fc over the previous pair, the max
    pooling of the last pair, a softmax fc and ``classification_cost``.
    Returns (output, cost)."""
    L = paddle.layer
    words = L.data("words", paddle.data_type.integer_value_sequence(
        cfg["vocab"]))
    label = L.data("label", paddle.data_type.integer_value(
        cfg.get("classes", 2)))
    fc = L.fc(L.embedding(words, size=cfg["emb"]), size=4 * cfg["hid"])
    lstm = L.lstmemory(fc, size=cfg["hid"])
    for i in range(2, cfg["layers"] + 1):
        fc = L.fc([fc, lstm], size=4 * cfg["hid"])
        lstm = L.lstmemory(fc, size=cfg["hid"], reverse=(i % 2) == 0)
    pooled = [L.pooling(v, pooling_type=paddle.pooling.Max())
              for v in (fc, lstm)]
    out = L.fc(pooled, size=cfg.get("classes", 2),
               act=paddle.activation.Softmax())
    return out, L.classification_cost(input=out, label=label)


def v2_mnist_net(paddle):
    """The book's ``recognize_digits`` conv net in v2: two
    ``networks.simple_img_conv_pool`` (20 and 50 filters of 5 x 5, ReLU,
    2 x 2 max pools) over the 28 x 28 image and a softmax fc. Returns
    (output, cost)."""
    from paddle_tpu_torch import layers
    L = paddle.layer
    images = L.data("pixel", paddle.data_type.dense_vector(784))
    label = L.data("label", paddle.data_type.integer_value(10))
    conv = layers.reshape(images, [-1, 1, 28, 28])
    for filters in (20, 50):
        conv = paddle.networks.simple_img_conv_pool(
            conv, num_filters=filters, filter_size=5, pool_size=2,
            pool_stride=2, act="relu")
    flat = layers.reshape(conv, [-1, 50 * 4 * 4])
    out = L.fc(flat, size=10, act=paddle.activation.Softmax())
    return out, L.classification_cost(input=out, label=label)


def v2_topology(paddle, net, seed, device, optimizer):
    """``net(paddle)`` built in fresh programs, its names the same at
    every build, with its Parameters and ``paddle.trainer.SGD`` on
    ``device`` (None: the ``paddle.init`` device), and a fresh scope that
    every call on the topology runs under (``core.scope_guard``)."""
    from paddle_tpu_torch import core
    main, startup = core.Program(), core.Program()
    startup.random_seed = seed
    with core.unique_name.guard(), core.program_guard(main, startup):
        out, cost = net(paddle)
        params = paddle.parameters.create(cost, device=device)
        sgd = paddle.trainer.SGD(cost=cost, parameters=params,
                                 update_equation=optimizer(), device=device)
    return dict(scope=core.Scope(), out=out, cost=cost, params=params,
                sgd=sgd)


def v2_costs(paddle, sgd, reader, feeding):
    """The costs of ``sgd.train`` over ``reader``, one an EndIteration."""
    costs = []
    sgd.train(reader, num_passes=1, feeding=feeding,
              event_handler=lambda e: costs.append(e.cost) if isinstance(
                  e, paddle.event.EndIteration) else None)
    return costs


def v2_pair(paddle, net, seed, optimizer, batches, feeding):
    """``len(batches)`` SGD steps of ``net`` on the card and on the CPU
    from the card's startup, crossed by ``Parameters.to_tar`` and
    ``init_from_tar`` (``SGD.test`` over the first batch runs each
    build's startup first): (losses by device, their worst relative
    difference)."""
    import io
    from paddle_tpu_torch import core
    tops = {dev: v2_topology(paddle, net, seed, dev, optimizer)
            for dev in ("cuda", "cpu")}
    first = [batches[0]]
    tar = io.BytesIO()
    with core.scope_guard(tops["cuda"]["scope"]):
        tops["cuda"]["sgd"].test(lambda: iter(first), feeding=feeding)
        tops["cuda"]["params"].to_tar(tar)
    losses = {}
    for dev, top in tops.items():
        with core.scope_guard(top["scope"]):
            if dev == "cpu":
                top["sgd"].test(lambda: iter(first), feeding=feeding)
                top["params"].init_from_tar(io.BytesIO(tar.getvalue()))
            losses[dev] = v2_costs(paddle, top["sgd"],
                                   lambda: iter(batches), feeding)
    err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                   losses["cpu"]))
    return losses, err


def v2_imdb_batches(cfg, rs, n):
    """``n`` batches of ``cfg["batch"]`` (word ids, label) samples as
    Python lists: lengths uniform in [min_len, max_len], the first of
    each batch max_len long (every batch pads to max_len), ids in [2,
    vocab), labels 0/1."""
    out = []
    for _ in range(n):
        lengths = rs.randint(cfg["min_len"], cfg["max_len"] + 1,
                             cfg["batch"])
        lengths[0] = cfg["max_len"]
        labels = rs.randint(0, 2, cfg["batch"])
        out.append([(rs.randint(2, cfg["vocab"], k).tolist(), int(y))
                    for k, y in zip(lengths, labels)])
    return out


def phase_v2_small(paddle, seed):
    """The v2 IMDB script at ``LSTM_SMALL``'s widths: 5 Adam steps on the
    card against the CPU from one tar."""
    small = dict(LSTM_SMALL, min_len=LSTM_SMALL["t"] // 2,
                 max_len=LSTM_SMALL["t"])
    batches = v2_imdb_batches(small, np.random.RandomState(seed + 54),
                              small["compare_steps"])
    losses, err = v2_pair(
        paddle, lambda p: v2_imdb_net(p, small), seed + 5,
        lambda: paddle.optimizer.Adam(learning_rate=small["lr"]), batches,
        {"words": 0, "label": 1})
    print("[v2] small IMDB script (vocab %d, T %d, width %d, %d layers, "
          "batch %d): %d SGD steps card %s cpu %s from one tar, rel err "
          "%.3g (tolerance %.0e)" % (
              small["vocab"], small["t"], small["hid"], small["layers"],
              small["batch"], len(batches),
              [round(v, 6) for v in losses["cuda"]],
              [round(v, 6) for v in losses["cpu"]], err, V2_LOSS_RTOL))
    check(err <= V2_LOSS_RTOL, "[v2] small IMDB card against CPU %.3g"
          % err)


def phase_v2_mnist(paddle, seed):
    """The book's ``recognize_digits`` conv net over
    ``paddle.dataset.mnist.train()`` (the surrogate without the files) at
    batch 64, Momentum(0.01, 0.9): 3 steps card against CPU from one tar,
    then 30 steps on the card whose loss falls below half its first."""
    from paddle_tpu_torch import core
    cfg = V2_MNIST
    batches = []
    for b in paddle.batch(paddle.dataset.mnist.train(), cfg["batch"])():
        batches.append(b)
        if len(batches) == cfg["steps"]:
            break
    feeding = {"pixel": 0, "label": 1}

    def momentum():
        return paddle.optimizer.Momentum(momentum=cfg["momentum"],
                                         learning_rate=cfg["lr"])
    losses, err = v2_pair(paddle, v2_mnist_net, seed + 7, momentum,
                          batches[:cfg["compare_steps"]], feeding)
    print("[v2] MNIST conv net (batch %d): %d SGD steps card %s cpu %s from "
          "one tar, rel err %.3g (tolerance %.0e)" % (
              cfg["batch"], cfg["compare_steps"],
              [round(v, 6) for v in losses["cuda"]],
              [round(v, 6) for v in losses["cpu"]], err, V2_LOSS_RTOL))
    check(err <= V2_LOSS_RTOL, "[v2] MNIST card against CPU %.3g" % err)
    top = v2_topology(paddle, v2_mnist_net, seed + 7, None, momentum)
    t0 = time.perf_counter()
    with core.scope_guard(top["scope"]):
        costs = v2_costs(paddle, top["sgd"], lambda: iter(batches), feeding)
    w = cfg["window"]
    first, last = float(np.mean(costs[:w])), float(np.mean(costs[-w:]))
    print("[v2] MNIST conv net on the card: %d SGD steps in %.1f s, mean "
          "loss of the first %d %.6f, of the last %d %.6f (must fall below "
          "x%.1f)" % (len(costs), time.perf_counter() - t0, w, first, w,
                      last, cfg["fall"]))
    check(len(costs) == cfg["steps"] and np.isfinite(costs).all() and
          last < cfg["fall"] * first,
          "[v2] MNIST loss did not fall: %s -> %s" % (first, last))


def phase_v2(seed, fluid_step_ms):
    """[v2]: the v2 API on the card. The IMDB recipe (``v2_imdb_net`` at
    ``LSTM_SENT``'s widths: vocabulary 30000, embedding 128, hidden 512, 3
    layers, batch 128, padded length 100, lengths uniform in [50, 100])
    trained by ``paddle.trainer.SGD.train`` over ``paddle.batch`` of a
    seeded reader of Python samples with ``feeding``, Adam(1e-3): the
    step from ``EndIteration`` events (10 warm-up steps, then 5 windows
    of 10), a profiled step's busy share, the peak, beside
    ``[lstm-sentiment]``'s step of this run (``fluid_step_ms``: the same
    widths through the fluid front end); ``SGD.test`` over a held-out
    reader and ``paddle.infer`` on the card; the card's
    ``Parameters.to_tar`` into a CPU build of the topology, whose
    ``paddle.infer`` the card's must match within ``V2_INFER_ATOL``; and
    first the small IMDB script and the MNIST conv net card against CPU.
    No TPU kernel lies on this path: the launch counts over the phase are
    printed."""
    import io
    import torch
    from torch.profiler import ProfilerActivity, profile
    import paddle_tpu_torch.v2 as paddle
    from paddle_tpu_torch import core
    t0 = time.perf_counter()
    reset_launches()
    paddle.init(device="cuda", trainer_count=1)
    phase_v2_small(paddle, seed)
    phase_v2_mnist(paddle, seed)
    cfg = dict(LSTM_SENT, min_len=LSTM_SENT["min_len"],
               max_len=LSTM_SENT["max_len"])
    net = functools.partial(v2_imdb_net, cfg=cfg)

    def adam():
        return paddle.optimizer.Adam(learning_rate=cfg["lr"])
    top = v2_topology(paddle, net, seed + 5, None, adam)
    pool = v2_imdb_batches(cfg, np.random.RandomState(seed + 52),
                           V2_IMDB_POOL)
    held = v2_imdb_batches(cfg, np.random.RandomState(seed + 53), 2)
    steps = cfg["warmup"] + cfg["windows"] * cfg["window_steps"] + 1

    def samples():
        for i in range(steps):
            yield from pool[i % len(pool)]
    feeding = {"words": 0, "label": 1}
    stamps, costs, prof = [], [], {}

    def handler(e):
        last = getattr(e, "batch_id", None) == steps - 1
        if isinstance(e, paddle.event.BeginIteration) and last:
            torch.cuda.synchronize()
            prof["session"] = profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA])
            prof["session"].__enter__()
            prof["t0"] = time.perf_counter()
        if isinstance(e, paddle.event.EndIteration):
            stamps.append(time.perf_counter())
            costs.append(e.cost)
            if last:
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - prof["t0"]) * 1e6
                prof["session"].__exit__(None, None, None)
                prof["busy"] = profile_summary(
                    prof["session"], "v2 IMDB LSTM: one SGD.train step",
                    wall_us)
    with core.scope_guard(top["scope"]):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        top["sgd"].train(paddle.batch(samples, cfg["batch"]), num_passes=1,
                         event_handler=handler, feeding=feeding)
        peak = torch.cuda.max_memory_allocated()
        check(len(costs) == steps and np.isfinite(costs).all(),
              "[v2] IMDB training: %d costs of %d steps, last %s"
              % (len(costs), steps, costs[-1:]))
        w0, ws = cfg["warmup"], cfg["window_steps"]
        windows = [(stamps[w0 + (k + 1) * ws - 1] - stamps[w0 + k * ws - 1])
                   * 1e3 / ws for k in range(cfg["windows"])]
        step_ms = float(np.median(windows))
        busy = prof.get("busy")
        print("[v2] IMDB LSTM through paddle.trainer.SGD.train (batch %d x T "
              "%d, vocab %d, embedding %d, hidden %d, %d layers, Adam(%g)): "
              "step %.3f ms (median of %d windows of %d after %d warm-up, "
              "EndIteration to EndIteration: %s), %.1f sequences/s, loss "
              "%.6f -> %.6f, busy %s, peak allocated %.2f GB (%.2f GB "
              "before); [lstm-sentiment]'s step in this run %.3f ms (x%.3f); "
              "%s" % (
                  cfg["batch"], cfg["max_len"], cfg["vocab"], cfg["emb"],
                  cfg["hid"], cfg["layers"], cfg["lr"], step_ms,
                  cfg["windows"], ws, w0, [round(x, 3) for x in windows],
                  cfg["batch"] / step_ms * 1e3, costs[0], costs[-1],
                  "not measured" if busy is None else "%.1f%%" % (
                      100 * busy["busy_share"]), peak / 1e9, base / 1e9,
                  fluid_step_ms, step_ms / fluid_step_ms, card_line()))

        # where the step beyond the fluid one goes: the feeding of one
        # batch on the host, and the v2 program's step through
        # Executor.run on a batch fed to the card once, as
        # [lstm-sentiment] times its program
        trainer = top["sgd"]._trainer
        feeds, feed_ms = [], []
        for batch in pool:
            t1 = time.perf_counter()
            feeds.append(trainer.feeder.feed(batch))
            feed_ms.append((time.perf_counter() - t1) * 1e3)
        feed = cuda_feed(feeds[0])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(ws):
            trainer.exe.run(trainer.main_program, feed=feed,
                            fetch_list=[top["cost"]], return_numpy=False)
        torch.cuda.synchronize()
        exe_ms = (time.perf_counter() - t1) * 1e3 / ws
        print("[v2] the step apart: DataFeeder.feed of one batch of %d "
              "Python samples %.3f ms on the host (median of %d); the v2 "
              "program's step through Executor.run on a batch fed once, %d "
              "steps closed by a synchronize, %.3f ms ([lstm-sentiment]'s "
              "program %.3f ms); SGD.train's step %.3f ms; %s" % (
                  cfg["batch"], float(np.median(feed_ms)), len(feed_ms), ws,
                  exe_ms, fluid_step_ms, step_ms, card_line()))

        def held_samples():
            for b in held:
                yield from b
        result = top["sgd"].test(paddle.batch(held_samples, cfg["batch"]),
                                 feeding=feeding)
        rows = held[0][:V2_INFER_ROWS]
        probs = paddle.infer(output_layer=top["out"],
                             parameters=top["params"], input=rows,
                             feeding=feeding)
        tar = io.BytesIO()
        top["params"].to_tar(tar)
    check(np.isfinite(result.cost), "[v2] SGD.test cost %s" % result.cost)
    cpu = v2_topology(paddle, net, seed + 5, "cpu", adam)
    with core.scope_guard(cpu["scope"]):
        cpu["params"].init_from_tar(io.BytesIO(tar.getvalue()))
        want = paddle.infer(output_layer=cpu["out"], parameters=cpu["params"],
                            input=rows, feeding=feeding, device="cpu")
    err = float(np.abs(probs - want).max())
    print("[v2] SGD.test over %d held-out batches on the card: cost %.6f; "
          "paddle.infer of %d held-out samples on the card against the "
          "card's tar (%d parameters, %.1f MB) in a CPU build: max abs "
          "difference %.3g of probabilities (tolerance %.0e)" % (
              len(held), result.cost, len(rows),
              len(top["params"].names()), len(tar.getvalue()) / 1e6, err,
              V2_INFER_ATOL))
    check(probs.shape == (len(rows), 2) and np.isfinite(probs).all() and
          err <= V2_INFER_ATOL, "[v2] infer card against CPU: shape %s, "
          "err %.3g" % (probs.shape, err))
    print("[v2] kernel launches over the phase (no TPU kernel lies on the "
          "v2 path): %s" % read_launches())
    print("[v2] done in %.1f s" % (time.perf_counter() - t0))
    return dict(step_ms=step_ms, exe_ms=exe_ms, peak=peak)


def lm_generate_program(**kw):
    """``transformer_lm_generate`` at ``bench_paged_kv``'s accelerator
    configuration: (main, startup, [ids, lengths, scores])."""
    from paddle_tpu_torch import core, layers
    from paddle_tpu_torch.models.transformer import transformer_lm_generate
    main, startup = core.Program(), core.Program()
    with core.unique_name.guard(), core.program_guard(main, startup):
        anchor = layers.data("anchor", shape=[1], dtype="int32")
        outs = transformer_lm_generate(anchor, bos_id=0, eos_id=1,
                                       **dict(LM_GENERATE, **kw))
    return main, startup, list(outs)


def phase_lm_generate(seed):
    """[lm-generate]: ``transformer_lm_generate`` at ``bench_paged_kv``'s
    accelerator configuration (``bench.py``: vocabulary 1024, d_model 512,
    8 heads, d_ff 2048, 4 layers, max_len 64, batch 8) on weights drawn
    from the seed as the reference's parity tests draw them (standard
    normal): beam 1, beam 4 and sampling; eager and replayed ms a call,
    B2 (f32, head dim 64) launches a call (4 layers x 64 steps); beam 1
    equal to a KV-cached paged ``GenerationSession``'s greedy tokens from
    ``[bos]`` on the same weights, sampling to its sampled tokens with
    the same seed and knobs. Returns B2's launches a call."""
    import torch
    from paddle_tpu_torch import core, io
    from paddle_tpu_torch.models.transformer import transformer_lm_session
    from paddle_tpu_torch.serving import GenerationSession
    from paddle_tpu_torch.serving.decoding import DecodePolicy
    t0 = time.perf_counter()
    cfg = LM_GENERATE
    _, startup, _ = lm_generate_program(beam_size=1)
    init = core.Scope()
    core.Executor(device="cpu").run(startup, scope=init)
    rs = np.random.RandomState(seed + 7)
    named = {n: rs.standard_normal(tuple(init.find_var(n).shape))
             .astype(np.float32) for n in sorted(init.var_names())
             if not n.startswith("@")}
    scope = io.scope_from_jax(named, device="cuda")
    feed = cuda_feed({"anchor": np.zeros((LM_GENERATE_BATCH, 1), np.int32)})
    per_call = {}
    streams = {}
    for tag, kw in (("beam 1", dict(beam_size=1)),
                    ("beam 4", dict(beam_size=4)),
                    ("sample", dict(decode="sample",
                                    **LM_GENERATE_SAMPLE))):
        main, _, outs = lm_generate_program(**kw)
        reset_launches()
        eager_ms, replay_ms, eager, same = generation_times(
            main, feed, outs, scope, LM_GENERATE_RUNS)
        launches = read_launches()["flash_attention"]
        # the eager run, the capture's count once, and each replay's
        calls = 2 + LM_GENERATE_RUNS
        per_call[tag] = launches / calls
        streams[tag] = eager
        print("[lm-generate] %s, batch %d, %d tokens: eager %.3f ms, "
              "replayed %.3f ms a call (median of %d); replays bitwise the "
              "eager run: %s; B2 f32 launches %d over %d calls (%.1f a "
              "call); %s" % (tag, LM_GENERATE_BATCH, cfg["max_len"],
                             eager_ms, replay_ms, LM_GENERATE_RUNS, same,
                             launches, calls, per_call[tag], card_line()))
        check(same and per_call[tag] == cfg["num_layers"] * cfg["max_len"],
              "[lm-generate] %s: replay %s, %s B2 launches a call"
              % (tag, same, per_call[tag]))
    for tag in ("beam 1", "sample"):
        ids, lengths = (v.cpu().numpy() for v in streams[tag][:2])
        pol = DecodePolicy(kind="sample", temperature=LM_GENERATE_SAMPLE[
            "temperature"], top_k=LM_GENERATE_SAMPLE["top_k"]) \
            if tag == "sample" else None
        spec = transformer_lm_session(
            cfg["vocab_size"], d_model=cfg["d_model"],
            num_heads=cfg["num_heads"], d_ff=cfg["d_ff"],
            num_layers=cfg["num_layers"], max_len=cfg["max_len"], slots=2,
            cache_len=cfg["max_len"] + 16, prompt_buckets=(8,), bos_id=0,
            eos_id=1, paged=True, block_size=16, num_blocks=0,
            decode_policy=pol, device="cuda")
        sess = GenerationSession(spec, io.scope_from_jax(named,
                                                         device="cuda"))
        try:
            got = [int(t) for t in sess.generate(
                [0], max_new_tokens=cfg["max_len"],
                seed=LM_GENERATE_SAMPLE["sample_seed"]
                if tag == "sample" else 0)]
        finally:
            sess.close()
        want = [int(t) for t in ids[0][:int(lengths[0])]]
        print("[lm-generate] %s: the cached paged session from [bos] gives "
              "the uncached tokens: %s (%d tokens)" % (tag, got == want,
                                                       len(want)))
        check(got == want, "[lm-generate] %s: cached %s uncached %s"
              % (tag, got[:12], want[:12]))
    print("[lm-generate] done in %.1f s" % (time.perf_counter() - t0))
    return per_call["beam 4"]


# -- the distribution slice: wide&deep (BASELINE config 5) with distributed
# tables, and the strategy route on a one-rank NCCL group -----------------

# bench.py bench_recsys's on-card configuration
RECSYS = dict(vocab=200_000, slots=26, emb_dim=32, batch=4096,
              hidden=(64, 32), lr=0.05, steps=30, dense=8)
RECSYS_COMPARE_STEPS = 3
RECSYS_LOSS_RTOL = 1e-4     # 3 Adagrad steps, card against the CPU: the
#                             sums of the fc products in another order
RECSYS_SPARSE_STEPS = 10    # the is_sparse pass's timed steps
DIST_LM_LAYERS = 2          # [dist]'s LM: full width, cut in depth
DIST_LM_BATCH, DIST_LM_T = 8, 1024
DIST_LM_STEPS = 2
DIST_WD_STEPS = 3
DIST_RING = (2, 1024, 16, 128)      # ring attention's [B, T, H, D]
DIST_RING_RTOL, DIST_RING_ATOL = 2e-4, 2e-5
DIST_RING_GRAD_RTOL, DIST_RING_GRAD_ATOL = 2e-3, 2e-4


def recsys_program(cfg, dist=True):
    """bench_recsys's program through the port's front end: wide&deep
    with distributed (or is_sparse) tables, Adagrad(0.05)."""
    from paddle_tpu_torch import core, layers, optimizer
    from paddle_tpu_torch.models.wide_deep import wide_deep
    main, startup = core.Program(), core.Program()
    with core.unique_name.guard(), core.program_guard(main, startup):
        ids = layers.data("ids", shape=[cfg["slots"]], dtype="int64")
        dense = layers.data("dense", shape=[cfg["dense"]])
        label = layers.data("label", shape=[1])
        loss, _, _ = wide_deep(ids, dense, label, cfg["vocab"],
                               cfg["slots"], emb_dim=cfg["emb_dim"],
                               hidden=cfg["hidden"], is_sparse=not dist,
                               is_distributed=dist)
        optimizer.Adagrad(cfg["lr"]).minimize(loss, startup)
    return main, startup, loss


def recsys_batches(cfg, n=3):
    """bench_recsys's host batches: RandomState(7), int32 ids."""
    rs = np.random.RandomState(7)
    return [{"ids": rs.randint(0, cfg["vocab"], (cfg["batch"],
                                                  cfg["slots"]))
             .astype("int32"),
             "dense": rs.randn(cfg["batch"], cfg["dense"])
             .astype("float32"),
             "label": rs.randint(0, 2, (cfg["batch"], 1)).astype("float32")}
            for _ in range(n)]


@contextlib.contextmanager
def port_flags(**kw):
    from paddle_tpu_torch import config
    prev = {k: config.get_flag(k) for k in kw}
    config.set_flags(**kw)
    try:
        yield
    finally:
        config.set_flags(**prev)


@contextlib.contextmanager
def recorded_sparse_grads(shapes):
    """Record the (Rows, Values) shapes every sparse gradient op makes."""
    from paddle_tpu_torch.core import registry
    defs = [registry.get_op_def(t) for t in ("lookup_table_dist_grad",
                                              "lookup_table_sparse_grad")]
    origs = [d.compute for d in defs]

    def wrap(orig):
        def compute(ctx):
            out = orig(ctx)
            shapes.append((tuple(out["Rows"].shape),
                           tuple(out["Values"].shape)))
            return out
        return compute
    for d, o in zip(defs, origs):
        d.compute = wrap(o)
    try:
        yield
    finally:
        for d, o in zip(defs, origs):
            d.compute = o


def recsys_pass(cfg, dist, batches, steps):
    """One regime of [recsys]: the program, card against CPU over the
    first steps from one startup, then one warm and ``steps`` timed
    batches through StagedReader and Executor.run (every launch count at
    0 before the timed pass), and a profiled step. Returns its numbers."""
    import torch
    from paddle_tpu_torch import core
    from paddle_tpu_torch.reader.staging import StagedReader
    main, startup, loss = recsys_program(cfg, dist)
    block = main.global_block()
    for t in ("deep_embedding", "wide_embedding"):
        check(not block.has_var(t + "@GRAD") and
              block.has_var(t + "@GRAD@VALUES"),
              "[recsys] %s has a dense gradient variable" % t)
    init = core.Scope()
    core.Executor(device="cpu").run(startup, scope=init)
    losses, shapes = {}, []
    with recorded_sparse_grads(shapes):
        for dev in ("cpu", "cuda"):
            scope = scope_copy(init, dev)
            exe = core.Executor(device=dev)
            losses[dev] = [float(exe.run(main, feed=f, fetch_list=[loss],
                                         scope=scope)[0])
                           for f in batches[:RECSYS_COMPARE_STEPS]]
    err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                   losses["cpu"]))
    total = cfg["batch"] * cfg["slots"]
    vp = block.var("deep_embedding").shape[0]
    check(err <= RECSYS_LOSS_RTOL, "[recsys] card against CPU: %.3g" % err)
    check(shapes and all(r == (total,) and v[0] == total and v[0] < vp
                         for r, v in shapes),
          "[recsys] a sparse gradient is not [ids]: %s" % shapes[:4])

    def reader(n):
        def gen():
            for i in range(n):
                yield dict(batches[i % len(batches)])
        return gen
    scope = scope_copy(init, "cuda")
    exe = core.Executor(device="cuda")
    sr = StagedReader(reader(1), program=main, device="cuda")  # warm
    for staged in sr():
        exe.run(main, feed=staged, fetch_list=[loss], scope=scope)
    sr.close()
    torch.cuda.synchronize()
    reset_launches()
    sr = StagedReader(reader(steps), program=main, device="cuda")
    last = None
    t0 = time.perf_counter()
    for staged in sr():
        last = exe.run(main, feed=staged, fetch_list=[loss], scope=scope,
                       return_numpy=False)[0]
    final = float(last)
    elapsed = time.perf_counter() - t0
    sr.close()
    launches = read_launches()
    check(np.isfinite(final), "[recsys] the loss is not finite")
    sr = StagedReader(reader(2), program=main, device="cuda")
    staged = list(sr())
    exe.run(main, feed=staged[0], fetch_list=[loss], scope=scope)
    busy = profile_window(
        "[recsys] one %s step" % ("distributed" if dist else "is_sparse"),
        lambda: exe.run(main, feed=staged[1], fetch_list=[loss],
                        scope=scope, return_numpy=False))
    sr.close()
    return dict(losses=losses, err=err, shapes=shapes[:2], elapsed=elapsed,
                final=final, launches=launches, busy=busy,
                ex_per_sec=cfg["batch"] * steps / elapsed,
                rows_per_sec=2 * total * steps / elapsed)


def phase_recsys(seed):
    """[recsys]: BASELINE config 5 as bench.py's bench_recsys runs it on
    the card (vocab 200,000, 26 slots, emb_dim 32, batch 4096, hidden
    (64, 32), Adagrad(0.05), packed feeds, embedding_shard_rows and
    embedding_a2a on; one shard, so no strategy): the first 3 steps card
    against CPU from one startup, every sparse gradient [batch * slots]
    rows (no [V, D] gradient), 30 timed steps after a warm one through
    StagedReader and Executor.run (recsys_examples_per_sec,
    embedding_lookup_rows_per_sec: both tables count), a profiled step's
    busy share, the static a2a bytes a step of the f32 and int8 wires,
    and the same for an is_sparse pass."""
    from paddle_tpu_torch.embeddings.sharded import a2a_step_bytes
    cfg = RECSYS
    t0 = time.perf_counter()
    batches = recsys_batches(cfg)
    out = {}
    with port_flags(embedding_shard_rows=True, embedding_a2a=True,
                    packed_feeds=True):
        for dist, steps in ((True, cfg["steps"]),
                            (False, RECSYS_SPARSE_STEPS)):
            tag = "distributed" if dist else "is_sparse"
            r = out[tag] = recsys_pass(cfg, dist, batches, steps)
            print("[recsys] %s tables: losses card %s cpu %s, rel err %.3g "
                  "(tolerance %.0e); sparse gradients (Rows, Values) %s, "
                  "no [V, D] gradient" % (
                      tag, [round(v, 6) for v in r["losses"]["cuda"]],
                      [round(v, 6) for v in r["losses"]["cpu"]], r["err"],
                      RECSYS_LOSS_RTOL, r["shapes"]))
            print("[recsys] %s: %d timed steps in %.3f s (loss %.6f): "
                  "recsys_examples_per_sec %.1f, "
                  "embedding_lookup_rows_per_sec %.1f, busy %s, launches %s"
                  "; %s" % (tag, steps, r["elapsed"], r["final"],
                            r["ex_per_sec"], r["rows_per_sec"],
                            "not measured" if r["busy"] is None else
                            "%.1f%%" % (100 * r["busy"]["busy_share"]),
                            {k: v for k, v in r["launches"].items() if v}
                            or "none (no kernel on this path)",
                            card_line()))
    total = cfg["batch"] * cfg["slots"]
    f32_step = int8_step = 0
    for dim in (cfg["emb_dim"], 1):
        ids_b, rows_b = a2a_step_bytes(total, dim, 1, itemsize=4)
        f32_step += ids_b + rows_b
        ids8, rows8 = a2a_step_bytes(total, dim, 1, itemsize=1)
        int8_step += ids8 + rows8 + total * 4
    print("[recsys] embedding_a2a_bytes_per_step %d (f32 wire), %d (int8 "
          "wire), 1-shard tables, vocab %d, %d slots" % (
              f32_step, int8_step, cfg["vocab"], cfg["slots"]))
    print("[recsys] done in %.1f s" % (time.perf_counter() - t0))
    return out


def phase_dist(seed):
    """[dist]: the strategy route on the card, over a one-rank NCCL group
    made by ``distributed.init_multihost``: (1) the LM program at full
    width and DIST_LM_LAYERS layers, amp bf16, Adam, under
    DistStrategy(make_mesh({"data": 1, "model": 1}),
    transformer_tp_rules()) against strategy=None from the same startup
    weights, B2 bf16 launched through the per-shard route (counted);
    (2) [recsys]'s wide&deep under DataParallel(n_devices=1) against
    strategy=None; (3) ring_attention over a one-rank axis against
    dense_attention, forward and gradients. Returns B2's launches."""
    import torch
    from paddle_tpu_torch import core, parallel
    from paddle_tpu_torch.distributed import (init_multihost,
                                              shutdown_multihost)
    from paddle_tpu_torch.models.transformer import transformer_tp_rules
    from paddle_tpu_torch.ops.attention_ops import sharded_attention
    import socket
    t0 = time.perf_counter()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    rank, world = init_multihost("localhost:%d" % port, 1, 0,
                                 initialization_timeout_sec=60)
    check(torch.distributed.get_backend() == "nccl",
          "[dist] the process group is not NCCL's")
    try:
        mesh = parallel.make_mesh({"data": 1, "model": 1})
        strat = parallel.DistStrategy(mesh,
                                      param_rules=transformer_tp_rules())
        cfg = dict({k: v for k, v in FULL.items() if k != "max_len"},
                   num_layers=DIST_LM_LAYERS)
        main, startup, loss, _ = lm_program(cfg, DIST_LM_T, 1e-4)
        init = core.Scope()
        startup.random_seed = seed
        core.Executor(device="cuda").run(startup, scope=init)
        feed = lm_feed(DIST_LM_BATCH, DIST_LM_T, cfg["vocab_size"], "cuda")
        losses, counts = {}, {}
        with amp_flag("bfloat16"):
            for name, st in (("none", None), ("strategy", strat)):
                scope = scope_copy(init)
                exe = core.Executor(device="cuda", strategy=st)
                reset_launches()
                sharded_attention.per_shard = 0
                losses[name] = [float(exe.run(main, feed=feed,
                                              fetch_list=[loss],
                                              scope=scope)[0])
                                for _ in range(DIST_LM_STEPS)]
                counts[name] = dict(read_launches(),
                                    per_shard=sharded_attention.per_shard)
                if st is not None:
                    stats = exe.capture_stats()
                del scope, exe
                gc.collect()
                torch.cuda.empty_cache()
        del init
        bitwise = losses["none"] == losses["strategy"]
        err = max(abs(a - b) / abs(b) for a, b in zip(losses["strategy"],
                                                       losses["none"]))
        want = DIST_LM_LAYERS * DIST_LM_STEPS
        print("[dist] LM program, full width, %d layers, batch %d x T %d, "
              "amp bf16, Adam: strategy %s vs none %s: %s (rel err %.3g, "
              "bound %.0e: the global mean divides the all-reduced sum, "
              "where the plain op takes torch's mean); B2 bf16 launches %d"
              " (%d through the per-shard route, %d expected); captures "
              "%s" % (DIST_LM_LAYERS, DIST_LM_BATCH, DIST_LM_T,
                      losses["strategy"], losses["none"],
                      "bitwise equal" if bitwise else "not bitwise equal",
                      err, PROGRAM_LM_LOSS_RTOL,
                      counts["strategy"]["flash_attention bf16"],
                      counts["strategy"]["per_shard"], want, stats))
        check(err <= PROGRAM_LM_LOSS_RTOL, "[dist] LM under the strategy")
        check(counts["strategy"]["flash_attention bf16"] == want and
              counts["strategy"]["per_shard"] == want,
              "[dist] B2 per-shard launches %s" % counts["strategy"])
        check(stats["refused"] >= 1 and stats["captures"] == 0,
              "[dist] a step under the strategy was captured: %s" % stats)
        # (2) wide&deep under DataParallel(1)
        rc = RECSYS
        batches = recsys_batches(rc)
        wd = {}
        with port_flags(embedding_shard_rows=True, embedding_a2a=True):
            wmain, wstartup, wloss = recsys_program(rc)
            winit = core.Scope()
            core.Executor(device="cuda").run(wstartup, scope=winit)
            for name, st in (("none", None),
                             ("strategy", parallel.DataParallel(
                                 n_devices=1))):
                scope = scope_copy(winit)
                exe = core.Executor(device="cuda", strategy=st)
                wd[name] = [float(exe.run(wmain, feed=f, fetch_list=[wloss],
                                          scope=scope)[0])
                            for f in batches[:DIST_WD_STEPS]]
        wd_err = max(abs(a - b) / abs(b) for a, b in zip(wd["strategy"],
                                                         wd["none"]))
        print("[dist] wide&deep under DataParallel(n_devices=1): %s vs "
              "none %s: %s (rel err %.3g, bound %.0e)" % (
                  wd["strategy"], wd["none"],
                  "bitwise equal" if wd["strategy"] == wd["none"]
                  else "not bitwise equal", wd_err, RECSYS_LOSS_RTOL))
        check(wd_err <= RECSYS_LOSS_RTOL, "[dist] wide&deep under dp")
        # (3) ring attention over a one-rank axis
        rmesh = parallel.make_mesh({"sp": 1})
        g = torch.Generator(device="cuda").manual_seed(seed)
        q, k, v = (0.5 * torch.randn(DIST_RING, device="cuda", generator=g)
                   for _ in range(3))
        outs = []
        for fn in (lambda a, b, c: parallel.ring_attention(
                a, b, c, rmesh, axis_name="sp", causal=True),
                   lambda a, b, c: parallel.dense_attention(a, b, c,
                                                           causal=True)):
            qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
            o = fn(qs, ks, vs)
            (o * o).sum().backward()
            outs.append((o.detach(), qs.grad, ks.grad, vs.grad))
        fwd_err = float((outs[0][0] - outs[1][0]).abs().max())
        grad_ok = all(torch.allclose(a, b, rtol=DIST_RING_GRAD_RTOL,
                                     atol=DIST_RING_GRAD_ATOL)
                      for a, b in zip(outs[0][1:], outs[1][1:]))
        print("[dist] ring_attention over a one-rank axis, %s causal: "
              "forward max|diff| %.3g against dense_attention (rtol %.0e "
              "atol %.0e), gradients within rtol %.0e atol %.0e: %s" % (
                  list(DIST_RING), fwd_err, DIST_RING_RTOL, DIST_RING_ATOL,
                  DIST_RING_GRAD_RTOL, DIST_RING_GRAD_ATOL, grad_ok))
        check(torch.allclose(outs[0][0], outs[1][0], rtol=DIST_RING_RTOL,
                             atol=DIST_RING_ATOL) and grad_ok,
              "[dist] ring attention against dense")
    finally:
        shutdown_multihost()
    print("[dist] done in %.1f s (rank %d of %d); %s" % (
        time.perf_counter() - t0, rank, world, card_line()))
    return counts["strategy"]


# -- the training supervisor, the elastic control plane and the telemetry
# plane, around [pipeline]'s configuration ------------------------------------

def counter_value(name):
    from paddle_tpu_torch.observability import metrics
    return metrics.REGISTRY.families()[name].value


def no_rng(state):
    return {n: v for n, v in state.items() if n != "@RNG_STATE@"}


def phase_resilient(seed):
    """ResilientTrainer over [pipeline]'s trainer (packed uint8 feeds,
    staged, async metrics), cuDNN deterministic: the step's cost beside the
    plain Trainer's (passes in turns plain, supervised, supervised, plain);
    a NaN loss skipped (parameters, velocities and running statistics
    bitwise unchanged across it, the budget counters moved, B1 30 times a
    step, a finite pass); a NaN loss rolled back to the last checkpoint
    with the learning rate halved (the restore timed); a reader error
    retried to a pass bitwise equal to a fault-free one; SIGTERM mid-pass
    checkpointed with the resume metadata, resumed by a fresh trainer to
    a state bitwise equal to an uninterrupted pass; a step past the
    watchdog's deadline counted once. Returns the program and its weights
    for the phases after."""
    import os
    import shutil
    import signal
    import tempfile
    import torch
    from paddle_tpu_torch import config, core, io
    from paddle_tpu_torch.resilience import (RecoveryPolicy,
                                             ResilientTrainer, faults)
    from paddle_tpu_torch.trainer import EndIteration, Trainer
    R = RESILIENT
    torch.cuda.empty_cache()
    main, startup, loss = pipeline_program(PIPELINE)
    startup.random_seed = seed
    init = core.Scope()
    core.Executor(device="cuda").run(startup, scope=init)
    hosts = pipeline_batches(PIPELINE)
    steps = R["steps"]

    def batches(n, start=0, wide=False):
        # ``wide``: the images widened on the host to float32 (a float
        # feed, which nan_loss can poison: a uint8 one holds no NaN)
        out = [dict(hosts[i % len(hosts)]) for i in range(start, n)]
        if wide:
            for b in out:
                b["img"] = b["img"].astype(np.float32) * \
                    np.float32(PIPELINE_SCALE)
        return out

    def make(policy=None, plain=False, **kw):
        if plain:
            tr = Trainer(loss, main_program=main, startup_program=startup,
                         async_metrics=True, device="cuda", **kw)
        else:
            tr = ResilientTrainer(loss, main_program=main,
                                  startup_program=startup,
                                  async_metrics=True, device="cuda",
                                  policy=policy or RecoveryPolicy(), **kw)
        tr._initialized = True       # on a copy of the startup's weights
        return tr

    def run(tr, scope, bs, events=None):
        with core.scope_guard(scope):
            return tr.train(lambda: iter([dict(b) for b in bs]),
                            num_passes=1, event_handler=events)

    prev = {k: config.get_flag(k) for k in ("packed_feeds",
                                            "nonfinite_guard")}
    config.set_flags(packed_feeds=True)
    tmp = tempfile.mkdtemp(prefix="resilient_")
    try:
        # the supervisor's cost: passes of R["timing_steps"] in turns
        times = {"plain": [], "supervised": []}
        for kind in ("plain", "supervised", "supervised", "plain"):
            scope = scope_copy(init)
            tr = make(plain=kind == "plain")
            run(tr, scope, batches(1))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(tr, scope, batches(R["timing_steps"]))
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t0)
                               / R["timing_steps"] * 1e3)
            del tr, scope
        plain_ms = float(np.median(times["plain"]))
        sup_ms = float(np.median(times["supervised"]))
        print("[resilient] %s; ResNet-50 f32 fused, batch %d at %d, packed "
              "staged feeds: %.3f ms a step under ResilientTrainer (passes "
              "%s) beside %.3f ms under the plain Trainer (%s), %.3fx: the "
              "finite check's read of each step's loss"
              % (card_line(), PIPELINE["batch"], PIPELINE["res"], sup_ms,
                 [round(t, 3) for t in times["supervised"]], plain_ms,
                 [round(t, 3) for t in times["plain"]], sup_ms / plain_ms))

        with deterministic_cudnn():
            # skip: the NaN step leaves every tensor as it was
            k = R["skip_at"]
            scope = scope_copy(init)
            seen, marks, losses = {}, [], []

            def grab(e):
                if isinstance(e, EndIteration):
                    marks.append(bool(e.metrics.get("skipped_nonfinite")))
                    losses.append(e.cost)
                    if e.step_id in (k, k + 1):
                        seen[e.step_id] = no_rng(scope_state(scope))

            c0 = [counter_value("paddle_resilience_%s" % n) for n in
                  ("nonfinite_steps_total", "skipped_steps_total")]
            faults.arm("nan_loss", at=k)
            reset_launches()
            run(make(RecoveryPolicy(nonfinite_policy="skip",
                                    nonfinite_budget=2)), scope,
                batches(steps, wide=True), grab)
            faults.disarm()
            launches = read_launches()
            moved = [counter_value("paddle_resilience_%s" % n) - c
                     for n, c in zip(("nonfinite_steps_total",
                                      "skipped_steps_total"), c0)]
            differ = bitwise_diff(seen[k], seen[k + 1])
            print("[resilient] skip (float32 feeds, packed): NaN loss at "
                  "step %d of %d: marks %s, "
                  "%d of %d tensors differ in bits across the skipped step "
                  "%s; nonfinite/skipped counters moved %s; B1 %d launches "
                  "(%g a step); losses %s"
                  % (k + 1, steps, marks, len(differ), len(seen[k]),
                     differ[:5], moved, launches["conv_bn_stats"],
                     launches["conv_bn_stats"] / steps,
                     [round(float(v), 4) for v in losses]))
            check(marks == [i == k for i in range(steps)],
                  "skip marks %s" % marks)
            check(not differ, "the skipped step changed %s" % differ[:5])
            check(moved == [1, 1], "skip counters moved %s" % moved)
            check(np.isfinite(float(losses[-1])), "the skip pass ended "
                  "non-finite")
            check(launches["conv_bn_stats"] == B1_PER_STEP * steps,
                  "B1 launches %d != %d x %d steps"
                  % (launches["conv_bn_stats"], B1_PER_STEP, steps))
            check(all(v == 0 for n, v in launches.items()
                      if n != "conv_bn_stats"),
                  "another kernel launched: %s" % launches)
            del scope, seen

            # rollback to the last checkpoint, lr halved
            scope = scope_copy(init)
            lr_names = sorted(n for n, _ in scope.items()
                              if n.startswith("learning_rate"))
            lr0 = {n: float(scope.find_var(n)) for n in lr_names}
            tr = make(RecoveryPolicy(nonfinite_policy="rollback",
                                     nonfinite_budget=3,
                                     lr_backoff=R["lr_backoff"]),
                      checkpoint_dir=os.path.join(tmp, "rollback"),
                      checkpoint_every_n_steps=R["ckpt_every"])
            restore_s, real = [], tr.restore_checkpoint

            def timed_restore():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = real()
                torch.cuda.synchronize()
                restore_s.append(time.perf_counter() - t0)
                return out

            tr.restore_checkpoint = timed_restore
            rolled = []
            faults.arm("nan_loss", at=R["rollback_at"])
            r0 = counter_value("paddle_resilience_rollbacks_total")
            run(tr, scope, batches(R["rollback_steps"], wide=True),
                lambda e: rolled.append(e.metrics.get("rolled_back_to"))
                if isinstance(e, EndIteration) else None)
            faults.disarm()
            lr1 = {n: float(scope.find_var(n)) for n in lr_names}
            want = {n: float(np.float32(v) * np.float32(R["lr_backoff"]))
                    for n, v in lr0.items()}
            print("[resilient] rollback (float32 feeds, packed): NaN loss at "
                  "step %d, checkpoints "
                  "every %d: rolled back to %s, learning rates %s -> %s; "
                  "the restore %.3f s (digest-verified load of a %.1f MB "
                  "checkpoint onto the card)"
                  % (R["rollback_at"] + 1, R["ckpt_every"],
                     [m for m in rolled if m is not None], lr0, lr1,
                     restore_s[0] if restore_s else float("nan"),
                     sum(os.path.getsize(os.path.join(dp, f))
                         for dp, _, fs in os.walk(os.path.join(
                             tmp, "rollback")) for f in fs
                         if "checkpoint_%d" % R["ckpt_every"] in dp)
                     / 1e6))
            check([m for m in rolled if m is not None] ==
                  [R["ckpt_every"]], "rollback marks %s" % rolled)
            check(counter_value("paddle_resilience_rollbacks_total") ==
                  r0 + 1, "the rollback counter did not move")
            check(lr_names and lr1 == want, "learning rates %s, want %s"
                  % (lr1, want))
            del scope, tr

            # a reader error retried: the pass bitwise the fault-free one
            outs = []
            for fault in (False, True):
                scope = scope_copy(init)
                r0 = counter_value("paddle_resilience_reader_retries_total")
                if fault:
                    faults.arm("reader_error", at=R["reader_fault_at"])
                tr = make(RecoveryPolicy(reader_backoff=0.001))
                run(tr, scope, batches(steps))
                faults.disarm()
                outs.append((scope_state(scope), tr.step_id,
                             counter_value(
                                 "paddle_resilience_reader_retries_total")
                             - r0))
                del scope, tr
            differ = bitwise_diff(outs[0][0], outs[1][0])
            print("[resilient] reader retry: an IOError before batch %d, "
                  "retried (%g retries): %d steps against %d fault-free, "
                  "%d of %d tensors differ in bits"
                  % (R["reader_fault_at"], outs[1][2], outs[1][1],
                     outs[0][1], len(differ), len(outs[0][0])))
            check(outs[1][2] == 1 and outs[0][1] == outs[1][1] == steps,
                  "the reader retry: %s" % [o[1:] for o in outs])
            check(not differ, "the retried pass differs: %s" % differ[:5])
            del outs

            # SIGTERM mid-pass: checkpoint, resume, bitwise the whole pass
            whole = scope_copy(init)
            run(make(), whole, batches(steps))
            scope = scope_copy(init)
            ck = os.path.join(tmp, "preempt")
            p0 = counter_value("paddle_resilience_preemptions_total")

            def sigterm(e):
                if isinstance(e, EndIteration) and \
                        e.step_id == R["preempt_at"]:
                    signal.raise_signal(signal.SIGTERM)

            result = run(make(checkpoint_dir=ck,
                              checkpoint_every_n_steps=100), scope,
                         batches(steps), sigterm)
            meta = io.load_checkpoint_meta(ck)
            fresh = core.Scope()
            tr2 = ResilientTrainer(loss, main_program=main,
                                   startup_program=startup,
                                   async_metrics=True, device="cuda",
                                   checkpoint_dir=ck)
            with core.scope_guard(fresh):
                tr2.startup()
            resumed_at = tr2.step_id
            run(tr2, fresh, batches(steps, R["preempt_at"]))
            differ = bitwise_diff(scope_state(whole), scope_state(fresh))
            print("[resilient] preemption: SIGTERM after step %d: train() "
                  "returned %s; latest.json %s; a fresh ResilientTrainer "
                  "resumed at step %d and ran to step %d: %d of %d tensors "
                  "differ in bits from the uninterrupted pass"
                  % (R["preempt_at"], result,
                     {k: meta.get(k) for k in ("preempted", "reason",
                                               "step", "batch_id")},
                     resumed_at, tr2.step_id, len(differ),
                     len(scope_state(whole))))
            check(result and result.get("preempted") and
                  result["step"] == R["preempt_at"],
                  "the preempted pass returned %s" % result)
            check(meta.get("preempted") and meta.get("step") ==
                  R["preempt_at"] and meta.get("reason") ==
                  "signal_%d" % signal.SIGTERM, "latest.json %s" % meta)
            check(counter_value("paddle_resilience_preemptions_total") ==
                  p0 + 1, "the preemption counter did not move")
            check(resumed_at == R["preempt_at"], "resumed at %d"
                  % resumed_at)
            check(not differ, "the resumed pass differs: %s" % differ[:5])
            del whole, scope, fresh, tr2

        # the watchdog: one step past the deadline counted once
        scope = scope_copy(init)
        tr = make(RecoveryPolicy(step_deadline_sec=R["deadline_s"]))
        run(tr, scope, batches(1))           # the first step, untimed
        s0 = counter_value("paddle_resilience_watchdog_stalls_total")
        faults.arm("collective_hang", at=tr.step_id + 1, action="callback",
                   callback=lambda: time.sleep(R["hang_s"]))
        t0 = time.perf_counter()
        run(tr, scope, batches(3))
        faults.disarm()
        stalls = counter_value("paddle_resilience_watchdog_stalls_total") - s0
        print("[resilient] watchdog: a step held %.1f s against a %.1f s "
              "deadline: %g stall(s) counted, the 3-step pass %.2f s"
              % (R["hang_s"], R["deadline_s"], stalls,
                 time.perf_counter() - t0))
        check(stalls == 1, "watchdog stalls %g != 1" % stalls)
        del tr, scope
    finally:
        faults.disarm()
        config.set_flags(**prev)
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(main=main, startup=startup, loss=loss, init=init,
                hosts=hosts, step_ms=sup_ms, plain_ms=plain_ms)


def elastic_dataset(path, n, seed):
    """A RecordIO file of ``n`` (uint8 image, label) samples at
    [pipeline]'s width, from ``seed``: 8 samples a chunk. Returns its
    chunk count."""
    from paddle_tpu_torch.reader import recordio
    rs = np.random.RandomState(seed)
    r = PIPELINE["res"]
    recordio.write_recordio(
        path, ((rs.randint(0, 256, (3, r, r)).astype(np.uint8),
                int(rs.randint(0, 1000))) for _ in range(n)),
        max_chunk_bytes=8 * 3 * r * r)
    return recordio.num_chunks(path)


def phase_elastic(seed, ctx):
    """bench.py's bench_elastic_resume on the card, then
    ElasticTrainerLoop over a one-rank NCCL group with [pipeline]'s
    ResNet-50 as a ResilientTrainer over an ElasticDataDispatcher (a
    RecordIO file written from the seed), cuDNN deterministic: a peer
    that joins mid-pass and never beats forces one restart (the group
    aborted, brought up again at the later generation, the newest
    checkpoint restored, every chunk done); then a step hung past
    step_deadline_sec escalates watchdog -> collective_abort -> restart,
    and the first step after it equals the same step of a fresh trainer
    from the restored checkpoint, bit for bit."""
    import os
    import shutil
    import socket
    import tempfile
    import threading
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch import core, io
    from paddle_tpu_torch.distributed import (ElasticDataDispatcher,
                                              ElasticTrainerLoop,
                                              GenerationMismatch,
                                              MasterClient, MasterServer,
                                              elastic, launch)
    from paddle_tpu_torch.resilience import (RecoveryPolicy,
                                             ResilientTrainer, faults)
    from paddle_tpu_torch.trainer import EndIteration, Trainer
    E = ELASTIC
    main, startup, loss = ctx["main"], ctx["startup"], ctx["loss"]
    tmp = tempfile.mkdtemp(prefix="elastic_")
    try:
        # -- the recovery timing: detect a silent peer, restore onto the
        # card
        with core.scope_guard(ctx["init"]):
            io.save_checkpoint(core.Executor(device="cuda"),
                               os.path.join(tmp, "ckpt"), 1, main)
        srv = MasterServer(os.path.join(tmp, "snap"), timeout_sec=30,
                           heartbeat_timeout_ms=E["hb_timeout_ms"])
        try:
            # the doomed peer first: a join bumps the generation
            MasterClient(srv.port).register("doomed")
            c = MasterClient(srv.port)
            gen, _ = c.register("live")
            t0 = time.perf_counter()
            while True:
                try:
                    c.heartbeat("live", gen)
                except GenerationMismatch:
                    break
                time.sleep(0.02)
                check(time.perf_counter() - t0 < 30,
                      "the master never reaped the silent peer")
            detect_s = time.perf_counter() - t0
            new_gen, _ = c.register("live")
            scope = core.Scope()
            with core.scope_guard(scope):
                step = io.load_checkpoint(core.Executor(device="cuda"),
                                          os.path.join(tmp, "ckpt"), main)
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
        finally:
            srv.stop()
        print("[elastic] %s; elastic_resume %.4f s (the %.1f s heartbeat "
              "deadline is its floor; detection %.4f s, then re-register at "
              "generation %d -> %d and a digest-verified ResNet-50 "
              "checkpoint onto the card)"
              % (card_line(), resume_s, E["hb_timeout_ms"] / 1e3, detect_s,
                 gen, new_gen))
        check(new_gen == gen + 1 and step == 1, "re-registered at %d (was "
              "%d), restored step %s" % (new_gen, gen, step))
        check(resume_s >= E["hb_timeout_ms"] / 1e3, "resumed before the "
              "deadline could pass")
        del scope

        ds = os.path.join(tmp, "images.rio")
        chunks = elastic_dataset(ds, E["samples"], seed)
        aborts, inits = [], []
        real_abort, real_init = launch.abort_multihost, \
            elastic.init_multihost

        def counted_abort(*a, **kw):
            t0 = time.perf_counter()
            out = real_abort(*a, **kw)
            aborts.append((out, time.perf_counter() - t0))
            return out

        def counted_init(*a, **kw):
            inits.append(kw.get("generation"))
            return real_init(*a, **kw)

        launch.abort_multihost = counted_abort
        elastic.abort_multihost = counted_abort
        elastic.init_multihost = counted_init

        def loop_run(tag, policy, events, on_build=None):
            """One ElasticTrainerLoop pass over the dataset on a fresh
            master; returns (loop, master stats, cluster, groups)."""
            srv = MasterServer(os.path.join(tmp, "snap-" + tag),
                               timeout_sec=5,
                               heartbeat_timeout_ms=E["hb_timeout_ms"])
            groups = []
            with socket.socket() as s:
                s.bind(("localhost", 0))
                coord = "localhost:%d" % s.getsockname()[1]
            ck = os.path.join(tmp, "ckpt-" + tag)

            def build(world):
                t = torch.ones(1, device="cuda")
                dist.all_reduce(t)
                groups.append((world.generation, world.n_live,
                               float(t[0]), dist.get_world_size()))
                tr = ResilientTrainer(
                    loss, main_program=main, startup_program=startup,
                    device="cuda", checkpoint_dir=ck,
                    checkpoint_every_n_steps=E["ckpt_every"],
                    policy=policy())
                if on_build is not None:
                    on_build(tr, world)
                disp = ElasticDataDispatcher(world.client, ds,
                                             worker_id=world.worker_id,
                                             generation=world.generation)

                def reader():
                    imgs, labels = [], []
                    for img, label in disp.reader(poll_interval=0.05)():
                        imgs.append(img)
                        labels.append(label)
                        if len(imgs) == PIPELINE["batch"]:
                            b = {"img": np.stack(imgs), "label": np.asarray(
                                labels, np.int32).reshape(-1, 1)}
                            fed.append(b)
                            yield b
                            imgs, labels = [], []
                return tr, reader

            try:
                c = MasterClient(srv.port)
                check(ElasticDataDispatcher(c, ds).register_dataset() ==
                      chunks, "chunks registered")
                with core.scope_guard(core.Scope()):
                    loop = ElasticTrainerLoop(
                        build, srv.port, worker_id="w0",
                        heartbeat_interval_sec=E["hb_interval_s"],
                        coordinator_address=coord, num_processes=1,
                        initialization_timeout_sec=E["init_timeout_s"],
                        settle_sec=E["settle_s"])
                    loop.run(num_passes=1,
                             event_handler=lambda e: events(e, loop, c))
                return loop, c.stats(), c.cluster(), groups
            finally:
                launch.shutdown_multihost()
                srv.stop()

        with deterministic_cudnn():
            # a peer joins mid-pass and never beats
            fed, log, death = [], [], {}
            stop = threading.Event()

            def joined_peer(e, loop, c):
                if not isinstance(e, EndIteration):
                    return
                log.append((time.perf_counter(), loop.restarts, e.step_id,
                            float(e.cost)))
                if e.step_id == E["join_at"] and not death:
                    death["client"] = c
                    MasterClient(c.addr[1]).register("zz-silent")
                    death["joined"] = time.perf_counter()

                    def watch():
                        d0 = MasterClient(c.addr[1]).cluster()["deaths"]
                        w = MasterClient(c.addr[1])
                        while not stop.is_set():
                            if w.cluster()["deaths"] > d0:
                                death["declared"] = time.perf_counter()
                                return
                            time.sleep(0.005)
                    threading.Thread(target=watch, daemon=True).start()

            starts = []

            def record_start(tr, world):
                # the step each bring-up's startup() restored
                real = tr.startup

                def startup():
                    first = not tr._initialized
                    real()
                    if first:
                        starts.append(tr.step_id)
                tr.startup = startup

            n0 = len(aborts)
            loop, stats, cluster, groups = loop_run(
                "join", lambda: RecoveryPolicy(), joined_peer,
                record_start)
            stop.set()
            resumed = [t for t, r, _, _ in log if r == 1]
            print("[elastic] ElasticTrainerLoop, one-rank NCCL group, "
                  "ResNet-50 batch %d over %d RecordIO chunks: a silent "
                  "peer joined after step %d; generations %s, %d "
                  "restart(s); group bring-ups %s (generation, live, "
                  "all-reduce of ones, world); aborts %s; steps %s; master "
                  "%s, cluster %s; death declared %.3f s after the join, "
                  "first resumed step %.3f s after the death"
                  % (PIPELINE["batch"], chunks, E["join_at"],
                     loop.generations, loop.restarts, groups,
                     [(a, round(s, 4)) for a, s in aborts[n0:]],
                     [(s, r) for _, r, s, _ in log], stats, cluster,
                     death.get("declared", float("nan")) -
                     death.get("joined", float("nan")),
                     (resumed[0] if resumed else float("nan")) -
                     death.get("declared", float("nan"))))
            check(len(loop.generations) == 2 and loop.restarts == 1 and
                  loop.generations[1] > loop.generations[0],
                  "generations %s, restarts %d" % (loop.generations,
                                                   loop.restarts))
            check([g[0] for g in groups] == loop.generations and
                  all(g[1:] == (1, 1.0, 1) for g in groups),
                  "group bring-ups %s" % groups)
            check(any(a for a, _ in aborts[n0:]), "no group was aborted")
            check("declared" in death and resumed, "no death or no resume")
            check(stats["todo"] == 0 and stats["pending"] == 0 and
                  stats["done"] == chunks, "master stats %s" % stats)
            check(all(np.isfinite(v) for _, _, _, v in log),
                  "non-finite loss: %s" % log)
            stopped = max(s for _, r, s, _ in log if r == 0)
            print("[elastic] the restart: the first generation stopped at "
                  "step %d, its restart checkpoint restored at step %s"
                  % (stopped, starts))
            check(starts == [0, stopped], "bring-ups restored steps %s, "
                  "the first generation stopped at %d" % (starts, stopped))

            # a hung step: watchdog -> collective_abort -> restart
            fed, log = [], []
            after = {}

            def snapshot_restore(tr, world):
                # the state each bring-up starts from, once restored
                real = tr.startup

                def startup():
                    first = not tr._initialized
                    real()
                    if first:
                        after["start"] = (tr.step_id, no_rng(scope_state(
                            core.global_scope())))
                tr.startup = startup

            def hung(e, loop, c):
                if isinstance(e, EndIteration):
                    log.append((time.perf_counter(), loop.restarts,
                                e.step_id, float(e.cost)))
                    if loop.restarts == 1 and "step" not in after:
                        after["step"] = (e.step_id, float(e.cost),
                                         no_rng(scope_state(
                                             core.global_scope())),
                                         dict(fed[-1]))

            n0 = len(aborts)
            faults.arm("collective_hang", at=E["hang_at"])
            try:
                loop, stats, cluster, groups = loop_run(
                    "hang", lambda: RecoveryPolicy(
                        step_deadline_sec=E["deadline_s"]),
                    hung, snapshot_restore)
            finally:
                faults.disarm()
            hang_t = [t for t, r, s, _ in log if r == 0 and
                      s == E["hang_at"]]
            res_t = [t for t, r, _, _ in log if r == 1]
            bound = E["deadline_s"] + E["settle_s"] + 30.0
            gap = res_t[0] - hang_t[0] if hang_t and res_t else float("nan")
            # the first step after the abort against a fresh trainer's
            # same step from the restored state
            start_step, start_state = after["start"]
            step_id, cost, state, batch = after["step"]
            fresh = core.Scope()
            for n, v in start_state.items():
                fresh.set_var(n, v.clone())
            tr = Trainer(loss, main_program=main, startup_program=startup,
                         device="cuda")
            tr._initialized = True
            with core.scope_guard(fresh):
                ref_cost = float(tr.train_batch(batch)["loss"])
            differ = bitwise_diff(no_rng(scope_state(fresh)), state)
            print("[elastic] hang escalation: a step hung past a %.1f s "
                  "deadline: generations %s, %d restart(s), group "
                  "bring-ups %s, aborts %s (the abort %.4f s); the step "
                  "before the hang to the first resumed step %.3f s "
                  "(bound %.1f s); resumed from step %d: step %d loss %r "
                  "against %r from a fresh trainer on the restored state, "
                  "%d of %d tensors differ in bits; master %s"
                  % (E["deadline_s"], loop.generations, loop.restarts,
                     groups, [(a, round(s, 4)) for a, s in aborts[n0:]],
                     max([s for _, s in aborts[n0:]] or [float("nan")]),
                     gap, bound, start_step, step_id, cost, ref_cost,
                     len(differ), len(state), stats))
            check(loop.restarts == 1 and len(set(loop.generations)) == 1
                  and len(groups) == 2, "generations %s, restarts %d, "
                  "groups %s" % (loop.generations, loop.restarts, groups))
            check(inits[-2:] == ["%d.0" % loop.generations[0],
                                 "%d.1" % loop.generations[0]],
                  "group prefixes %s" % inits)
            check(any(a for a, _ in aborts[n0:]), "no group was aborted")
            check(gap < bound, "the hang took %.1f s to resume" % gap)
            check(cost == ref_cost and not differ, "the step after the "
                  "abort differs from a fresh trainer's: loss %r vs %r, %s"
                  % (cost, ref_cost, differ[:5]))
            check(stats["todo"] == 0 and stats["pending"] == 0,
                  "master stats %s" % stats)
    finally:
        launch.abort_multihost = real_abort
        elastic.abort_multihost = real_abort
        elastic.init_multihost = real_init
        launch.shutdown_multihost()
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(resume_s=resume_s, hang_s=gap)


def http_get(url):
    """(status, body bytes, seconds) of one GET."""
    import urllib.error
    import urllib.request
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read(), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.read(), time.perf_counter() - t0


def metric_families(text):
    """{prefix: [family names]} of a /metrics text for the generation,
    resilience and elastic prefixes."""
    return {p: sorted({ln.split()[2] for ln in text.splitlines()
                       if ln.startswith("# TYPE %s" % p)})
            for p in ("paddle_generation_", "paddle_resilience_",
                      "paddle_elastic_")}


def phase_telemetry_serve(paged, prompts, paged_outs):
    """The telemetry_port server beside the flagship LM's paged f32
    session: the five paged requests decode while a client thread GETs
    /metrics, /healthz, /debug/flight and /debug/trace?id= of a live
    request; the tokens equal the same requests' without scrapes."""
    import socket
    import tempfile
    import threading
    from paddle_tpu_torch import config
    from paddle_tpu_torch import distributed  # noqa: F401  (families)
    from paddle_tpu_torch.observability import flight, http
    from paddle_tpu_torch.observability import request_trace as rtrace
    from paddle_tpu_torch.resilience import supervisor  # noqa: F401
    from paddle_tpu_torch.serving import GenerationScheduler
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    fdir = tempfile.mkdtemp(prefix="flight_")
    config.set_flags(request_tracing=True, flight_dir=fdir,
                     telemetry_port=port)
    try:
        srv = http.active_server()
        check(srv is not None and srv.port == port, "no server on %d"
              % port)
        flight.RECORDER.trigger("telemetry_smoke")
        sched = GenerationScheduler(paged, autostart=False)
        futs = [sched.submit(p, max_new_tokens=NEW_TOKENS, eos_id=-1)
                for p in prompts]
        got, times, rounds, done = {}, [], [0], threading.Event()

        def scrape():
            while not done.is_set():
                for path in ("/metrics", "/healthz", "/debug/flight"):
                    code, body, dt = http_get(srv.url + path)
                    got[path] = (code, body)
                    times.append(dt)
                ids = rtrace.trace_ids()
                if ids:
                    code, body, dt = http_get(
                        srv.url + "/debug/trace?id=%s" % ids[-1])
                    got["/debug/trace"] = (code, body)
                    times.append(dt)
                rounds[0] += 1

        th = threading.Thread(target=scrape, daemon=True)
        th.start()
        sched.start()
        outs = [f.result(timeout=600) for f in futs]
        during = rounds[0]
        sched.drain(timeout=60)
        done.set()
        th.join(timeout=60)
    finally:
        config.set_flags(telemetry_port=0, request_tracing=False,
                         flight_dir=None)
    text = got.get("/metrics", (0, b""))[1].decode()
    fams = metric_families(text)
    equal = all(np.array_equal(a, b) for a, b in zip(outs, paged_outs))
    print("[telemetry] telemetry_port %d beside the paged f32 session: %d "
          "scrape rounds while %d requests decoded (%d GETs, median %.3f "
          "ms, max %.3f ms); statuses %s; /metrics families %s; tokens "
          "equal to the unscraped run: %s"
          % (port, during, len(prompts), len(times),
             float(np.median(times)) * 1e3 if times else float("nan"),
             max(times) * 1e3 if times else float("nan"),
             {p: c for p, (c, _) in got.items()},
             {p: len(v) for p, v in fams.items()}, equal))
    check(during >= 1, "no scrape finished while the requests decoded")
    check(all(got.get(p, (0,))[0] == 200 for p in
              ("/metrics", "/healthz", "/debug/flight", "/debug/trace")),
          "statuses %s" % {p: c for p, (c, _) in got.items()})
    check(fams["paddle_generation_"], "no generation family on /metrics")
    check(equal, "the scraped run's tokens differ")
    return float(np.median(times)) * 1e3


def phase_telemetry(seed, ctx):
    """bench.py's bench_slo with the port's modules (the detection
    latency on the driven clock, equal to the reference's; the
    aggregation overhead on the host clock), and one ResNet-50 step under
    utils.profiler.profiler(trace_dir): its torch.profiler trace holds
    B1's kernels."""
    import os
    import shutil
    import tempfile
    import torch
    from paddle_tpu_torch import core
    from paddle_tpu_torch.observability import aggregate, metrics, slo
    from paddle_tpu_torch.trainer import Trainer
    from paddle_tpu_torch.utils import profiler
    reg = metrics.Registry()
    hist = reg.histogram("paddle_bench_slo_e2e_ms", "bench latencies",
                         buckets=metrics.LATENCY_MS_BUCKETS)
    tracker = slo.SLOTracker(
        label="bench", target_p99_ms=100.0,
        source=slo.local_source(histogram="paddle_bench_slo_e2e_ms",
                                registry=reg))
    now = 0.0
    tracker.tick(now)
    while now < 90.0:
        now += 0.25
        for _ in range(8):
            hist.observe(10.0)
        tracker.tick(now)
    fault_start, detected = now, None
    while now < fault_start + 60.0:
        now += 0.25
        for _ in range(8):
            hist.observe(800.0)
        tracker.tick(now)
        if tracker.alerting:
            detected = now
            break
    tracker.close()
    detection_ms = (detected - fault_start) * 1e3 if detected else None
    reg = metrics.Registry()
    for i in range(20):
        c = reg.counter("paddle_bench_c%d_total" % i, "c",
                        labelnames=("route",))
        for j in range(16):
            c.labels(route="r%02d" % j).inc(j + 1)
    for i in range(6):
        h = reg.histogram("paddle_bench_h%d_ms" % i, "h",
                          labelnames=("route",),
                          buckets=metrics.LATENCY_MS_BUCKETS)
        for j in range(16):
            h.labels(route="r%02d" % j).observe(float(7 * j % 90))
    agg = aggregate.FleetAggregator("bench", registry=metrics.Registry())
    reps = 50
    t0 = time.perf_counter()
    for _ in range(reps):
        snap = aggregate.build_snapshot(max_bytes=aggregate.MAX_LINE - 1024,
                                        registry=reg)
        aggregate.encode_snapshot(snap)
        agg.ingest("m0", "i1", snap)
    cycle_s = (time.perf_counter() - t0) / reps
    print("[telemetry] slo_detection_latency_ms %r (driven clock, 0.25 s "
          "ticks, default windows; the reference's: %r); "
          "metrics_aggregation_overhead_pct %.4f (host clock: a %.4f ms "
          "build + encode + ingest cycle of 26 families x 16 children "
          "against a 1 s interval)"
          % (detection_ms, SLO_DETECTION_MS, cycle_s * 100.0,
             cycle_s * 1e3))
    check(detection_ms == SLO_DETECTION_MS, "SLO detection %r ms, the "
          "reference's %r" % (detection_ms, SLO_DETECTION_MS))

    # /metrics once the supervisor's and the elastic runtime's counters
    # have moved ([telemetry]'s serving half scraped before them)
    import socket
    from paddle_tpu_torch import config
    from paddle_tpu_torch.observability import http
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    config.set_flags(telemetry_port=port)
    try:
        code, body, dt = http_get(http.active_server().url + "/metrics")
    finally:
        config.set_flags(telemetry_port=0)
    fams = metric_families(body.decode())
    print("[telemetry] /metrics after [resilient] and [elastic] (%.3f ms, "
          "%d bytes): %s" % (dt * 1e3, len(body), fams))
    check(code == 200 and all(fams.values()), "families missing from "
          "/metrics: %s" % fams)

    # one ResNet-50 step under the profiler
    scope = scope_copy(ctx["init"])
    tr = Trainer(ctx["loss"], main_program=ctx["main"],
                 startup_program=ctx["startup"], async_metrics=True,
                 device="cuda")
    tr._initialized = True
    hb = ctx["hosts"][0]
    feed = {"img": torch.from_numpy(hb["img"].astype(np.float32) *
                                    np.float32(PIPELINE_SCALE)).cuda(),
            "label": torch.from_numpy(hb["label"]).cuda()}
    trace_dir = tempfile.mkdtemp(prefix="profiler_")
    try:
        with core.scope_guard(scope):
            float(tr._train_feed(feed)["loss"])
            reset_launches()
            with profiler.profiler(trace_dir) as handle:
                with profiler.RecordEvent("resnet50_step"):
                    float(tr._train_feed(feed)["loss"])
        launches = read_launches()
        with open(handle.device_trace) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        # the profiler names a kernel by its demangled signature
        b1 = sorted({n for n in ("w_transpose_kernel",
                                 "conv1x1_f32_stats_kernel",
                                 "stats_finish_kernel")
                     if any(n in k for k in kernels)})
        print("[telemetry] profiler(trace_dir) around one ResNet-50 step: "
              "%s, %d kernel events, B1's %s (%d launches counted), host "
              "table rows %s"
              % (os.path.basename(handle.device_trace), len(kernels), b1,
                 launches["conv_bn_stats"],
                 [ln.split()[0] for ln in handle.report().splitlines()[2:]]))
        check(kernels, "the device trace holds no kernel event")
        check("conv1x1_f32_stats_kernel" in b1, "B1's kernel is not in "
              "the trace: %s" % b1)
        check(launches["conv_bn_stats"] == B1_PER_STEP, "B1 launches %d "
              "in the profiled step" % launches["conv_bn_stats"])
        check("resnet50_step" in handle.report(), "the host table lacks "
              "the step's span")
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    return dict(detection_ms=detection_ms, overhead_pct=cycle_s * 100.0)


# [fleet] and [model-paging]: bench.py's bench_fleet and bench_model_paging
# on the card, at the flagship LM's full width and depth. Every member is
# a probes.fleet_worker process on this card serving dense program
# sessions at SLOTS, CACHE_LEN and BUCKETS over weights it loads from one
# .npz this process writes (the reference child's build_scope draw:
# standard normals, so greedy logits are far from ties); the router and
# the oracle (the same weights in-process) run here. The members' beats
# every 150 ms as the bench's, their deadline 2 s where the bench's is
# 0.7 s: a member loading 3 GB of weights for a swap or a page-in holds
# its interpreter for longer stretches than a CPU member; a SIGKILL is
# seen at once on the request's connection either way.
FLEET = dict(seed=7, requests=12, max_new=10, kill_at=4, prompt_seed=5,
             push=1.01, heartbeat_ms=150, deadline_ms=2000.0,
             replay_attempts=6, breaker_failures=2, deploy_max_new=4,
             deploy_canary=2, member_timeout_s=600)
PAGING = dict(seed_b=11, max_new=8, steady=12, prompt_seeds=(3, 23))
FLEET_LM = dict(vocab=FULL["vocab_size"], max_len=FULL["max_len"],
                d_model=FULL["d_model"], num_heads=FULL["num_heads"],
                d_ff=FULL["d_ff"], num_layers=FULL["num_layers"])


class FleetMembers:
    """The probes.fleet_worker processes of one phase: started together,
    each printing READY once registered; stopped through the ``stop``
    verb, each then printing its LAUNCHES line; every one killed and
    reaped on the way out."""

    def __init__(self, tmp, params, cache_dir):
        self.tmp, self.params, self.cache_dir = tmp, params, cache_dir
        self.procs = {}     # member id -> Popen
        self.ports = {}

    def start(self, router, mid, *extra):
        import os
        log = open(os.path.join(self.tmp, "%s.log" % mid), "w")
        cmd = [sys.executable, "-m", "paddle_tpu_torch.probes.fleet_worker",
               "--router", "%s:%d" % router.addr, "--member", mid,
               "--heartbeat-ms", str(FLEET["heartbeat_ms"]),
               "--compile-cache", self.cache_dir, "--params", self.params,
               "--slots", str(SLOTS), "--cache-len", str(CACHE_LEN),
               "--prompt-buckets", ",".join(str(b) for b in BUCKETS)]
        for k, v in FLEET_LM.items():
            cmd += ["--" + k.replace("_", "-"), str(v)]
        self.procs[mid] = subprocess.Popen(
            cmd + list(extra), stdout=subprocess.PIPE, stderr=log,
            text=True, cwd=os.path.dirname(os.path.abspath(__file__)))
        log.close()
        return self.procs[mid]

    def ready(self, mid):
        import select
        proc = self.procs[mid]
        got, _, _ = select.select([proc.stdout], [], [],
                                  FLEET["member_timeout_s"])
        if not got:
            proc.kill()
            raise SmokeFailure("fleet member %s printed nothing in %d s; "
                               "its log ends %s"
                               % (mid, FLEET["member_timeout_s"],
                                  self.log_tail(mid)))
        line = proc.stdout.readline().strip()
        if not line.startswith("READY"):
            self.procs[mid].kill()
            raise SmokeFailure("fleet member %s failed before READY: %r; "
                               "its log ends %s" % (mid, line,
                                                    self.log_tail(mid)))
        self.ports[mid] = int(line.split()[2])
        print("[fleet] member %s started: %s (%s)"
              % (mid, self.start_line(mid), card_line()))
        return self.ports[mid]

    def start_line(self, mid):
        """The member's ``fleet_worker_started`` fields: the seconds of
        its imports, its weights and its session's build and warm-up,
        and its compile cache's hits and misses."""
        import os
        with open(os.path.join(self.tmp, "%s.log" % mid)) as f:
            for ln in f:
                if "fleet_worker_started " in ln:
                    return json.loads(ln.split("fleet_worker_started ",
                                               1)[1])
        return None

    def log_tail(self, mid, n=3000):
        import os
        with open(os.path.join(self.tmp, "%s.log" % mid)) as f:
            return f.read()[-n:]

    def stop(self, mid, timeout=120):
        """Send ``stop`` and read the member's LAUNCHES line."""
        from paddle_tpu_torch.serving import wire
        wire.call_once(("127.0.0.1", self.ports[mid]), {"cmd": "stop"},
                       timeout=30.0, retries=1)
        out, _ = self.procs[mid].communicate(timeout=timeout)
        lines = [ln for ln in out.splitlines()
                 if ln.startswith("LAUNCHES ")]
        check(self.procs[mid].returncode == 0 and lines,
              "fleet member %s exited %s without its LAUNCHES line: %s"
              % (mid, self.procs[mid].returncode, self.log_tail(mid)))
        return json.loads(lines[-1][len("LAUNCHES "):])

    def close(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()


def member_launches(tag, got):
    """A member's LAUNCHES line: B2 12 times an admission and B4 12 times
    a decode step (the prefill and decode programs' multihead attention,
    graph replays counted as the executor counts them), both launched,
    nothing else."""
    layers = FULL["num_layers"]
    want = {"flash_attention.launches": layers * got["admissions"],
            "decode_attention.launches": layers * got["steps"]}
    counts = {k: v for k, v in got.items() if k.endswith(".launches") or
              k.endswith(".launches_bf16")}
    print("[%s] member %s (pid %d): %d admissions, %d decode steps, "
          "launches %s" % (tag, got["member"], got["pid"],
                           got["admissions"], got["steps"],
                           {k: v for k, v in counts.items() if v}))
    check(got["admissions"] > 0 and got["steps"] > 0 and
          all(counts[k] == want.get(k, 0) for k in counts),
          "[%s] member %s launched %s over %d admissions and %d steps, "
          "expected %s" % (tag, got["member"], counts, got["admissions"],
                           got["steps"], want))
    return want


def oracle_tokens(sched, prompts, max_new):
    futs = [sched.submit(p, max_new_tokens=max_new, eos_id=-1)
            for p in prompts]
    return [[int(t) for t in f.result(timeout=600)] for f in futs]


def hist_sum(name):
    """(count, sum) of the port registry's histogram ``name``."""
    from paddle_tpu_torch.observability import metrics
    samples = metrics.REGISTRY.dump().get(name, {}).get("samples", ())
    return (sum(s["count"] for s in samples),
            sum(s["sum"] for s in samples))


def fleet_draw(seed, path):
    """[model-paging]'s model B: drawn as the reference's
    ``build_scope(seed)`` on the host and written to ``path`` with its
    manifest, in a child process [fleet] starts first, so the draw (one
    core for ~30 s) runs beside [fleet]."""
    from paddle_tpu_torch.probes import fleet_worker as fw
    from paddle_tpu_torch.serving import model_paging
    params = fw.model_params(fw.build_scope(seed, device="cpu", **FLEET_LM))
    np.savez(path, **params)
    model_paging.write_weights_manifest(path, params)


def phase_fleet():
    """[fleet]: bench.py's bench_fleet. Two members; 12 prompts with one
    member SIGKILLed at streamed token 4 (every stream equal to the
    oracle's, p99, recovery, failovers); a scale-up through
    FleetAutoscaler.request_scale_up with the compile cache warm (spawn to
    first token); a rolling deploy of a x1.01 push under concurrent
    traffic (0 client errors, every response equal to its version's
    oracle); each surviving member's launches. Returns the weights' files
    and the oracle for [model-paging], and the members' B2 and B4
    launches."""
    import os
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="fleet_")
    path_b = os.path.join(tmp, "B.npz")
    draw_b = subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.fleet_draw"
         "(%d, %r)" % (PAGING["seed_b"], path_b)],
        cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        return dict(fleet_run(tmp), draw_b=draw_b, path_b=path_b)
    except BaseException:
        draw_b.kill()
        draw_b.wait()
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def fleet_run(tmp):
    """[fleet]'s body, its files in ``tmp``."""
    import os
    import threading
    import torch
    from paddle_tpu_torch.probes import fleet_worker as fw
    from paddle_tpu_torch.serving import model_paging, wire
    from paddle_tpu_torch.serving.autoscale import FleetAutoscaler
    from paddle_tpu_torch.serving.fleet import FleetRouter
    card = card_line()
    cache_dir = os.path.join(tmp, "compile_cache")
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    scope = fw.build_scope(FLEET["seed"], device="cuda", **FLEET_LM)
    draw_s = time.perf_counter() - t0
    v0_path, v1_path = os.path.join(tmp, "v0.npz"), os.path.join(tmp,
                                                                 "v1.npz")
    v0 = fw.model_params(scope)
    np.savez(v0_path, **v0)
    model_paging.write_weights_manifest(v0_path, v0)
    v1 = fw.model_params(scope, FLEET["push"])
    np.savez(v1_path, **v1)
    del v0
    files_s = time.perf_counter() - t0 - draw_s
    oracle = fw.make_scheduler(
        scope, slots=SLOTS, device="cuda", cache_len=CACHE_LEN,
        prompt_buckets=BUCKETS, replay_attempts=0, **FLEET_LM)
    del scope
    prompts = fw.chaos_prompts(FLEET["requests"], seed=FLEET["prompt_seed"])
    base = oracle_tokens(oracle, prompts, FLEET["max_new"])
    print("[fleet] weights: %d tensors drawn as the reference's "
          "build_scope(%d) in %.1f s, v0 and the x%.2f push written with "
          "v0's manifest in %.1f s (%.2f GB each); the oracle served %d "
          "prompts" % (len(v1), FLEET["seed"], draw_s, FLEET["push"],
                       files_s, os.path.getsize(v0_path) / 1e9,
                       len(prompts)))
    members = FleetMembers(tmp, v0_path, cache_dir)
    router = FleetRouter(heartbeat_timeout_ms=FLEET["deadline_ms"],
                         replay_attempts=FLEET["replay_attempts"],
                         breaker_failures=FLEET["breaker_failures"],
                         breaker_cooldown_ms=60000.0)
    failovers0 = registry_value("paddle_fleet_failover_total")
    rec0 = hist_sum("paddle_fleet_recovery_seconds")
    resets0 = registry_value("paddle_fleet_journal_resets_total")
    out = {}
    try:
        t0 = time.perf_counter()
        members.start(router, "m0", "--kill-at-token",
                      str(FLEET["kill_at"]))
        members.start(router, "m1")
        members.ready("m0")
        members.ready("m1")
        router.wait_members(2, timeout=FLEET["member_timeout_s"])
        start_s = time.perf_counter() - t0
        print("[fleet] two members started together and registered in "
              "%.1f s (%s)" % (start_s, card))

        # the p99 under a mid-generation SIGKILL of m0
        done_at = {}
        t0 = time.perf_counter()
        futures = []
        for i, p in enumerate(prompts):
            fut = router.submit(p, max_new_tokens=FLEET["max_new"],
                                eos_id=-1, meta=True)
            fut.add_done_callback(
                lambda f, i=i: done_at.__setitem__(i, time.perf_counter()))
            futures.append(fut)
        results = [f.result(timeout=600) for f in futures]
        wait_deadline = time.monotonic() + 10
        while len(done_at) < len(prompts) and \
                time.monotonic() < wait_deadline:
            time.sleep(0.005)
        check(len(done_at) == len(prompts),
              "[fleet] %d of %d completion stamps" % (len(done_at),
                                                      len(prompts)))
        lat_ms = [(done_at[i] - t0) * 1e3 for i in range(len(prompts))]
        mism = [i for i, (got, want) in enumerate(zip(results, base))
                if got["tokens"].tolist() != want]
        check(not mism, "[fleet] streams %s differ from the oracle's "
              "after the SIGKILL" % mism)
        members.procs["m0"].wait(timeout=60)
        check(members.procs["m0"].returncode == -9,
              "[fleet] m0 exited %s, not SIGKILLed"
              % members.procs["m0"].returncode)
        failovers = registry_value("paddle_fleet_failover_total") - \
            failovers0
        rec = hist_sum("paddle_fleet_recovery_seconds")
        rec_n, rec_s = rec[0] - rec0[0], rec[1] - rec0[1]
        resets = registry_value("paddle_fleet_journal_resets_total") - \
            resets0
        check(failovers >= 1 and rec_n >= 1 and resets == 0,
              "[fleet] %d failovers, %d recoveries, %d journal resets"
              % (failovers, rec_n, resets))
        p99 = float(np.percentile(lat_ms, 99))
        out.update(p99_ms=p99, recovery_s=rec_s / rec_n,
                   failovers=failovers)
        print("[fleet] kill: 12 of 12 streams equal to the oracle's; "
              "fleet_p99_under_kill_ms %.1f (p50 %.1f); "
              "paddle_fleet_recovery_seconds mean %.3f over %d "
              "recoveries; failovers %d, replays %s, journal resets 0 (%s)"
              % (p99, float(np.percentile(lat_ms, 50)), rec_s / rec_n,
                 rec_n, failovers, [r["replays"] for r in results], card))

        # scale-up through the autoscaler's spawn path, the cache warm
        free, total = torch.cuda.mem_get_info()
        print("[fleet] before the scale-up: %.1f of %.1f GB of the card "
              "free (m0 reaped)" % (free / 1e9, total / 1e9))
        check(free > 12e9, "[fleet] %.1f GB free for a member" % (free / 1e9))

        def as_spawn(mid):
            proc = members.start(router, mid)
            members.ready(mid)
            return proc
        scaler = FleetAutoscaler(
            router, as_spawn, members_max=8, burn_threshold=1.0,
            cooldown_ms=200.0, idle_ms=3600e3,
            spawn_timeout_ms=FLEET["member_timeout_s"] * 1e3,
            spawn_failure_budget=2, member_prefix="up")
        t_up0 = time.perf_counter()
        up_mid = scaler.request_scale_up()
        check(up_mid is not None, "[fleet] the autoscaler refused the "
              "scale-up")
        join_deadline = time.monotonic() + FLEET["member_timeout_s"]
        while up_mid not in router.members_live():
            check(time.monotonic() < join_deadline,
                  "[fleet] the scale-up member never joined")
            time.sleep(0.02)
        join_s = time.perf_counter() - t_up0
        while scaler.doc()["pending"]:
            scaler.tick()
            time.sleep(0.01)
        check(not scaler.spawn_failures, "[fleet] the autoscaler charged "
              "a spawn failure")
        scaler.close()
        first_token_ms = None
        try:
            conn = wire.LineConn.connect(
                ("127.0.0.1", members.ports[up_mid]), timeout=300.0)
            conn.send({"cmd": "generate", "prompt": prompts[0],
                       "max_new": 2, "eos_id": -1})
            while True:
                msg = conn.recv()
                check(msg is not None and msg.get("ev") != "err",
                      "[fleet] the scale-up member failed: %r; its log "
                      "ends %s" % (msg, members.log_tail(up_mid)))
                if msg.get("ev") == "tok" and first_token_ms is None:
                    first_token_ms = (time.perf_counter() - t_up0) * 1e3
                if msg.get("ev") == "done":
                    break
            conn.close()
        except OSError as exc:
            raise SmokeFailure("[fleet] the scale-up member's stream: %r; "
                               "its log ends %s"
                               % (exc, members.log_tail(up_mid)))
        check(msg["tokens"] == base[0][:2], "[fleet] the scale-up member's "
              "tokens %s, the oracle's %s" % (msg["tokens"], base[0][:2]))
        cache_files = sorted(os.listdir(cache_dir)) \
            if os.path.isdir(cache_dir) else []
        out["scale_up_ms"] = first_token_ms
        print("[fleet] scale_up_to_first_token_ms %.1f (request_scale_up "
              "-> READY and joined %.1f s -> first token; compile cache "
              "%d files) (%s)" % (first_token_ms, join_s, len(cache_files),
                                  card))

        # a rolling deploy under concurrent traffic
        stop = threading.Event()
        responses, errors = [], []

        def traffic(seed_):
            rs = np.random.RandomState(seed_)
            while not stop.is_set():
                p = [fw.BOS] + [int(t) for t in rs.randint(2, fw.VOCAB, 3)]
                try:
                    got = router.submit(
                        p, max_new_tokens=FLEET["deploy_max_new"],
                        eos_id=-1, meta=True).result(timeout=600)
                    responses.append((p, got))
                except Exception as exc:  # noqa: BLE001 — counted
                    errors.append(repr(exc))
        threads = [threading.Thread(target=traffic, args=(17 + i,),
                                    daemon=True) for i in range(2)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        t0 = time.perf_counter()
        deploy = router.rolling_deploy(
            params_path=v1_path, tag="v1",
            canary_requests=FLEET["deploy_canary"], watch_timeout=300,
            swap_timeout=600)
        deploy_s = time.perf_counter() - t0
        stop.set()
        for t in threads:
            t.join(timeout=600)
        check(deploy.get("ok"), "[fleet] the rolling deploy: %r" % deploy)
        mixed = [r for _, r in responses
                 if r["version_start"] != r["version"]]
        check(not errors and not mixed,
              "[fleet] deploy: client errors %s, %d mixed-version "
              "responses" % (errors[:3], len(mixed)))
        by_version = {"v0": [], "v1": []}
        for p, r in responses:
            by_version[r["version"]].append((p, r["tokens"].tolist()))
        for version, params in (("v0", None), ("v1", v1)):
            if params is not None:
                oracle.swap_weights(params, timeout=600)
            rows = by_version[version]
            want = oracle_tokens(oracle, [p for p, _ in rows],
                                 FLEET["deploy_max_new"])
            bad = [i for i, ((_, got), w) in enumerate(zip(rows, want))
                   if got != w]
            check(not bad, "[fleet] deploy: %d %s responses differ from "
                  "%s's oracle" % (len(bad), version, version))
        check(by_version["v1"], "[fleet] no response served by v1")
        out.update(deploy_errors=len(errors), deploy_s=deploy_s)
        print("[fleet] rolling deploy of the x%.2f push over %s in %.1f s "
              "under traffic: rolling_deploy_client_errors %d, %d "
              "responses (%d v0, %d v1), each equal to its version's "
              "oracle, none mixed (%s)"
              % (FLEET["push"], deploy["swapped"], deploy_s, len(errors),
                 len(responses), len(by_version["v0"]),
                 len(by_version["v1"]), card))
        launches = {"flash_attention": 0, "decode_attention": 0}
        for mid in router.members_live():
            want = member_launches("fleet", members.stop(mid))
            launches["flash_attention"] += want["flash_attention.launches"]
            launches["decode_attention"] += want["decode_attention.launches"]
        out["launches"] = launches
    finally:
        router.close()
        members.close()
    del v1
    print("[fleet] %.1f s in all (%s)" % (time.perf_counter() - t_phase,
                                          card))
    return dict(out, tmp=tmp, v0_path=v0_path, cache_dir=cache_dir,
                oracle=oracle)


def phase_model_paging(fleet):
    """[model-paging]: bench.py's bench_model_paging. Models A ([fleet]'s
    v0 weights, seed 7) and B (seed 11) in the catalog, a resident-bytes
    budget of 1.5 models, two members resident for A: the first B request
    pages B in and evicts A from its member (model_page_in_ms, the
    page-in's own time beside), then 12 A and 12 B requests interleaved
    (the residency hit rate); 0 client errors, every stream equal to its
    model's oracle, each member's launches."""
    import os
    import shutil
    from paddle_tpu_torch.probes import fleet_worker as fw
    from paddle_tpu_torch.serving.fleet import FleetRouter
    card = card_line()
    tmp, path_a, oracle = fleet["tmp"], fleet["v0_path"], fleet["oracle"]
    t_phase = time.perf_counter()
    out = {}
    members = None
    try:
        t0 = time.perf_counter()
        path_b = fleet["path_b"]
        check(fleet["draw_b"].wait(timeout=600) == 0,
              "[model-paging] drawing B failed (%s)"
              % fleet["draw_b"].returncode)
        with np.load(path_b) as data:
            b = {k: data[k] for k in data.files}
        nbytes = os.path.getsize(path_a)
        print("[model-paging] B, drawn as build_scope(%d) and written with "
              "its manifest beside [fleet], waited for and read in %.1f s; "
              "%.2f GB a model, the resident budget %.2f GB"
              % (PAGING["seed_b"], time.perf_counter() - t0, nbytes / 1e9,
                 1.5 * nbytes / 1e9))
        cold = [fw.BOS, 5, 9]
        prompts_a = fw.chaos_prompts(PAGING["steady"],
                                     seed=PAGING["prompt_seeds"][0])
        prompts_b = fw.chaos_prompts(PAGING["steady"],
                                     seed=PAGING["prompt_seeds"][1])
        with np.load(path_a) as data:
            oracle.swap_weights({k: data[k] for k in data.files},
                                timeout=600)
        base_a = oracle_tokens(oracle, prompts_a, PAGING["max_new"])
        oracle.swap_weights(b, timeout=600)
        del b
        base_b = oracle_tokens(oracle, [cold] + prompts_b,
                               PAGING["max_new"])
        base_cold, base_b = base_b[0], base_b[1:]
        oracle.close()
        del oracle
        fleet.pop("oracle")
        gc.collect()
        import torch
        torch.cuda.empty_cache()

        router = FleetRouter(
            heartbeat_timeout_ms=FLEET["deadline_ms"], replay_attempts=4,
            models={"A": {"params_path": path_a, "tag": "A@v0",
                          "bytes": nbytes, "tenants": ("acme",)},
                    "B": {"params_path": path_b, "tag": "B@v0",
                          "bytes": nbytes, "tenants": ("bravo",)}},
            resident_bytes=int(nbytes * 1.5),
            page_timeout_ms=FLEET["member_timeout_s"] * 1e3)
        members = FleetMembers(tmp, path_a, fleet["cache_dir"])
        page0 = registry_value("paddle_fleet_model_page_ins_total",
                               outcome="ok")
        evict0 = registry_value("paddle_fleet_model_evictions_total")
        hits0 = registry_value("paddle_fleet_model_residency_hits_total")
        miss0 = registry_value("paddle_fleet_model_residency_misses_total")
        pin0 = hist_sum("paddle_fleet_model_page_in_ms")
        try:
            t0 = time.perf_counter()
            for mid in ("m0", "m1"):
                members.start(router, mid, "--model", "A", "--version",
                              "A@v0")
            for mid in ("m0", "m1"):
                members.ready(mid)
            router.wait_members(2, timeout=FLEET["member_timeout_s"])
            print("[model-paging] two members resident for A registered "
                  "in %.1f s (%s)" % (time.perf_counter() - t0, card))
            t0 = time.perf_counter()
            got = router.submit(cold, max_new_tokens=PAGING["max_new"],
                                eos_id=-1, tenant="bravo",
                                meta=True).result(timeout=900)
            page_in_ms = (time.perf_counter() - t0) * 1e3
            check(got["tokens"].tolist() == base_cold,
                  "[model-paging] the cold B request's tokens differ from "
                  "B's oracle")
            pin = hist_sum("paddle_fleet_model_page_in_ms")
            check(registry_value("paddle_fleet_model_page_ins_total",
                                 outcome="ok") - page0 == 1
                  and pin[0] - pin0[0] == 1,
                  "[model-paging] the cold request did not page B in once")
            evicted = registry_value(
                "paddle_fleet_model_evictions_total") - evict0
            check(evicted >= 1, "[model-paging] paging B in evicted "
                  "nothing under a 1.5-model budget")
            errors, futs = [], []
            for pa, pb in zip(prompts_a, prompts_b):
                futs.append(router.submit(pa, max_new_tokens=PAGING[
                    "max_new"], eos_id=-1, tenant="acme"))
                futs.append(router.submit(pb, max_new_tokens=PAGING[
                    "max_new"], eos_id=-1, tenant="bravo"))
            streams = []
            for f in futs:
                try:
                    streams.append([int(t) for t in f.result(timeout=900)])
                except Exception as exc:  # noqa: BLE001 — counted
                    errors.append(repr(exc))
                    streams.append(None)
            want = [t for ab in zip(base_a, base_b) for t in ab]
            mism = [i for i, (g, w) in enumerate(zip(streams, want))
                    if g is not None and g != w]
            check(not errors and not mism,
                  "[model-paging] mixed traffic: errors %s, streams %s "
                  "differ from their model's oracle" % (errors[:3],
                                                        mism[:5]))
            hits = registry_value(
                "paddle_fleet_model_residency_hits_total") - hits0
            misses = registry_value(
                "paddle_fleet_model_residency_misses_total") - miss0
            hit_rate = hits / max(1.0, hits + misses)
            check(registry_value("paddle_fleet_model_page_ins_total",
                                 outcome="ok") - page0 == 1,
                  "[model-paging] steady traffic paged again")
            out.update(page_in_ms=page_in_ms, hit_rate=hit_rate,
                       errors=len(errors))
            print("[model-paging] model_page_in_ms %.1f (the first B "
                  "request: page-in, the flip's graph recapture and %d "
                  "tokens; paddle_fleet_model_page_in_ms %.1f), %d "
                  "eviction(s); model_residency_hit_rate %.3f (%d hits, "
                  "%d misses over 1 cold + %d mixed requests); "
                  "paging_client_errors %d; every stream equal to its "
                  "model's oracle (%s)"
                  % (page_in_ms, PAGING["max_new"], pin[1] - pin0[1],
                     evicted, hit_rate, hits, misses, len(futs),
                     len(errors), card))
            launches = {"flash_attention": 0, "decode_attention": 0}
            for mid in router.members_live():
                want = member_launches("model-paging", members.stop(mid))
                launches["flash_attention"] += \
                    want["flash_attention.launches"]
                launches["decode_attention"] += \
                    want["decode_attention.launches"]
            out["launches"] = launches
        finally:
            router.close()
    finally:
        if members is not None:
            members.close()
        if fleet["draw_b"].poll() is None:
            fleet["draw_b"].kill()
        fleet["draw_b"].wait()
        shutil.rmtree(tmp, ignore_errors=True)
    print("[model-paging] %.1f s in all (%s)"
          % (time.perf_counter() - t_phase, card))
    return out

# -- the op tail, detection and the image recipes: the 17 op types of
# ops/{detection,misc,legacy_tail}_ops.py, SSD and the benchmark/paddle/
# image recipes ------------------------------------------------------------

DETECT = dict(res=300, classes=21, batch=32, gt=8, lr=0.01, momentum=0.9,
              compare_batch=2, train_steps=30, window=10)
DETECT_RTOL = 1e-4          # one step at batch 2, cuDNN against the CPU
DETECT_MAP_ATOL = 1e-9      # mAP over the card's and the CPU's detections
VISION = dict(batch=64, compare_batch=2, lr=0.01, momentum=0.9, warmup=2,
              steps=10)
# (name, input side, classes): the benchmark/paddle/image recipes
VISION_MODELS = (("alexnet", 224, 1000), ("vgg19", 224, 1000),
                 ("googlenet", 224, 1000), ("smallnet", 32, 10))
VISION_RTOL = 1e-4          # one step at batch 2, cuDNN against the CPU
STEP_NUDGE = 1e-6           # the input's relative nudge, and the bound's
STEP_SPREAD = 8             # multiple of the spread it gives (step_pair)


def phase_ops_tail():
    """[ops] of the op tail: its 17 op types (``probes/op_cases.py``
    ``TAIL_CASES``) on the card against the CPU on the same inputs, each
    output on the card, a warm second call reading nothing back to the
    host (sync debug mode "error") but ``print``'s, whose printed line
    is checked instead: the CPU's text of the same values, one host read
    a call; and the registry: all 219 of the reference's op types, none
    pending."""
    import io
    import torch
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.ops import control_flow_ops as cf
    from paddle_tpu_torch.probes import op_cases as oc
    t0 = time.perf_counter()
    worst, checked = {}, set()
    for case in oc.TAIL_CASES:
        inputs = case.inputs()
        family = oc.tail_family(case.op_type)
        tol = OPS_RNN_RTOL if case.tol == oc.RNN else ops_tolerance(case)
        printed = {}
        for dev in ("cpu", "cuda"):
            with contextlib.redirect_stdout(io.StringIO()) as text:
                before = cf.HOST_READS["print"]
                printed[dev] = (op_call(case, inputs, dev)(),
                                cf.HOST_READS["print"] - before)
            printed[dev] += (text.getvalue(),)
        out = {dev: printed[dev][0] for dev in printed}
        if case.op_type == "print":
            want = "%s: %s\n" % (case.attrs["message"],
                                 out["cpu"]["Out"][0].numpy())
            check(printed["cuda"][1:] == printed["cpu"][1:] == (1, want),
                  "[ops] print: card %r, CPU %r" % (printed["cuda"][1:],
                                                    printed["cpu"][1:]))
        else:
            again = op_call(case, inputs, "cuda")
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                again()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        check(sorted(out["cuda"]) == sorted(out["cpu"]),
              "[ops] %s: slots differ" % case.id)
        for slot, vals in out["cpu"].items():
            for got, want in zip(out["cuda"][slot], vals):
                check(got.device.type == "cuda" and got.dtype == want.dtype
                      and got.shape == want.shape,
                      "[ops] %s %s: %s %s %s against %s %s" % (
                          case.id, slot, got.device, got.dtype,
                          tuple(got.shape), want.dtype, tuple(want.shape)))
                err = op_err(got, want)
                check(err <= tol, "[ops] %s %s: card against CPU %.3g > "
                      "%.3g" % (case.id, slot, err, tol))
                ratio = err / tol if tol else 0.0
                if ratio >= worst.get(family, (-1.0,))[0]:
                    worst[family] = (ratio, case.id, err, tol)
        checked.add(case.op_type)
    tail = set(oc.TAIL_OPS)
    check(tail <= checked and len(tail) == 17 and
          tail <= set(registry.registered_ops()) and
          len(registry.registered_ops()) == 219 and not registry.PENDING,
          "[ops] checked %d of the op tail's %d op types; %d registered, "
          "%d pending" % (len(tail & checked), len(tail),
                          len(registry.registered_ops()),
                          len(registry.PENDING)))
    print("[ops] %d op types of the op tail checked card against CPU (%d "
          "cases; print's line checked, one host read a call), %d of the "
          "reference's 219 op types registered, %d pending, in %.1f s" % (
              len(tail & checked), len(oc.TAIL_CASES),
              len(registry.registered_ops()), len(registry.PENDING),
              time.perf_counter() - t0))
    for family in sorted(worst):
        _, case_id, err, bound = worst[family]
        print("[ops]   %-10s worst %-32s %.3g (tolerance %.3g)"
              % (family, case_id, err, bound))


def ssd_program(seed, mode="train"):
    """``models.ssd.ssd_net`` at DETECT's size: training with
    Momentum(lr, momentum) over padded ground truth of DETECT["gt"] boxes
    an image, or the detections (``mode="infer"``)."""
    from paddle_tpu_torch import core, layers, optimizer
    from paddle_tpu_torch.models import ssd
    cfg = DETECT
    main, startup = core.Program(), core.Program()
    startup.random_seed = seed
    with core.unique_name.guard(), core.program_guard(main, startup):
        img = layers.data("img", shape=[3, cfg["res"], cfg["res"]])
        if mode == "infer":
            return main, startup, ssd.ssd_net(
                img, num_classes=cfg["classes"], mode="infer")
        gb = layers.data("gb", shape=[cfg["gt"], 4])
        gl = layers.data("gl", shape=[cfg["gt"]], dtype="int64")
        gc = layers.data("gc", shape=[], dtype="int64")
        loss, _, _ = ssd.ssd_net(img, num_classes=cfg["classes"],
                                 gt_box=gb, gt_label=gl, gt_count=gc)
        optimizer.Momentum(cfg["lr"], cfg["momentum"]).minimize(loss,
                                                                startup)
    return main, startup, loss


def ssd_batch(rs, n):
    """``n`` images with 1..gt boxes each (normalized corners), labels
    1..classes-1, padding label 0."""
    cfg = DETECT
    g = cfg["gt"]
    count = rs.randint(1, g + 1, n)
    boxes = np.zeros((n, g, 4), np.float32)
    labels = np.zeros((n, g), np.int64)
    for i in range(n):
        for j in range(count[i]):
            x0, y0 = rs.uniform(0.0, 0.7, 2)
            w, h = rs.uniform(0.1, 0.3, 2)
            boxes[i, j] = [x0, y0, min(x0 + w, 1.0), min(y0 + h, 1.0)]
            labels[i, j] = rs.randint(1, cfg["classes"])
    return {"img": rs.rand(n, 3, cfg["res"], cfg["res"]).astype(np.float32),
            "gb": boxes, "gl": labels, "gc": count.astype(np.int64)}


def scope_errs(a, b, names):
    """{name: ||a - b|| / ||b||} over ``names`` of two scopes, in float64
    (the small-ResNet phases' measure)."""
    return {n: rel_dist(a.find_var(n).cpu(), b.find_var(n).cpu())
            for n in names}


def step_pair(main, startup, loss, feed, tol, tag):
    """One step on the card and on the CPU from the same startup weights
    (drawn on the card, copied): the losses within ``tol``, and each
    persistable within max(``tol``, STEP_SPREAD x the step's spread) in
    relative L2, the spread being the largest relative L2 move of a
    persistable on the CPU when the input moves by STEP_NUDGE relative. A
    step of a ReLU and max-pool net is discontinuous: an activation
    within rounding of 0 or of its pool window's maximum sends its
    gradient elsewhere when the forward's rounding changes, which tensor
    it hits is chance, and the spread measures how far such a change
    moves this step's gradients. Returns the startup scope."""
    from paddle_tpu_torch import core
    init = core.Scope()
    core.Executor(device="cuda").run(startup, scope=init)
    nudged = dict(feed)
    nudged["img"] = (feed["img"] * (1 + STEP_NUDGE * np.random.RandomState(
        1).standard_normal(feed["img"].shape))).astype(np.float32)
    scopes, losses = {}, {}
    for run, dev, f in (("cpu", "cpu", feed), ("cuda", "cuda", feed),
                        ("nudged", "cpu", nudged)):
        scopes[run] = scope_copy(init, dev)
        losses[run] = float(np.asarray(core.Executor(device=dev).run(
            main, feed=f, fetch_list=[loss],
            scope=scopes[run])[0]).ravel()[0])
    names = [v.name for v in main.global_block().vars.values()
             if v.persistable and not v.name.startswith("@")]
    errs = scope_errs(scopes["cuda"], scopes["cpu"], names)
    spread = scope_errs(scopes["nudged"], scopes["cpu"], names)
    widest = max(names, key=spread.get)
    bound = max(tol, STEP_SPREAD * spread[widest])
    worst = max(names, key=errs.get)
    lerr = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    print("[%s] one step at batch %d from the same startup weights: loss "
          "card %.6f cpu %.6f (rel err %.3g, tolerance %.0e); %d "
          "persistables in relative L2, worst %s %.3g (bound %.3g: the "
          "step's spread under a %.0e nudge of the input %.3g, %s)" % (
              tag, feed["img"].shape[0], losses["cuda"], losses["cpu"],
              lerr, tol, len(names), worst, errs[worst], bound,
              STEP_NUDGE, spread[widest], widest))
    check(lerr <= tol and errs[worst] <= bound and
          np.isfinite(losses["cuda"]),
          "[%s] card against CPU: loss %.3g, %s %.3g > %.3g" % (
              tag, lerr, worst, errs[worst], bound))
    return init


def phase_detection(seed):
    """[detection]: ``ssd_net`` at its own widths on VOC's 21 classes at
    300 x 300 (priors at strides 4 and 8: 75² x 3 + 37² x 3 = 20,982),
    batch 32 with 1-8 ground-truth boxes an image (padded to 8), data
    from the seed, Momentum(0.01, 0.9): one step at batch 2 card against
    CPU from the same startup weights (``step_pair``: the loss, every
    parameter and velocity); 30 steps on one fixed batch on the
    card, the loss below half its first value; the infer program's
    detections at batch 2 card against CPU from the trained weights
    (labels equal, scores and boxes within tolerance), a warm second
    call (a fresh executor's first run) reading nothing back to the host;
    ``DetectionMAP`` over the card's detections equal to the CPU's over
    its own; the step (median of windows of 10), images/s, one step's
    busy share and the peak memory."""
    import torch
    from paddle_tpu_torch import core, evaluator
    cfg = DETECT
    t0 = time.perf_counter()
    main, startup, loss = ssd_program(seed)
    infer, _, dets = ssd_program(seed, "infer")
    priors = sum(int(np.prod(v.shape[:3])) for v in
                 main.global_block().vars.values()
                 if v.name.startswith("prior_box") and
                 v.name.endswith("tmp_0"))
    check(priors == 75 * 75 * 3 + 37 * 37 * 3,
          "[detection] %d priors" % priors)
    rs = np.random.RandomState(seed)
    batch = ssd_batch(rs, cfg["batch"])
    small = {k: v[:cfg["compare_batch"]] for k, v in batch.items()}
    init = step_pair(main, startup, loss, small, DETECT_RTOL, "detection")
    # 30 steps on the fixed batch, timed in windows of 10
    scope = scope_copy(init, "cuda")
    exe = core.Executor(device="cuda")
    feed = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    losses, windows = [], []
    for _ in range(cfg["train_steps"] // cfg["window"]):
        t1 = time.perf_counter()
        for _ in range(cfg["window"]):
            out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                           return_numpy=False)
            losses.append(out)
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t1) * 1e3 / cfg["window"])
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    print("[detection] %d steps on one batch of %d: loss %.4f -> %.4f "
          "(%.3f of the first; below 0.5 required)" % (
              cfg["train_steps"], cfg["batch"], losses[0], losses[-1],
              losses[-1] / losses[0]))
    check(all(np.isfinite(losses)) and losses[-1] < 0.5 * losses[0],
          "[detection] the loss did not halve: %s" % losses)
    step_ms = float(np.median(windows))
    busy = profile_window("detection one training step", lambda: exe.run(
        main, feed=feed, fetch_list=[loss], scope=scope,
        return_numpy=False))
    print("[detection] step %.3f ms (median of %d windows of %d: %s), "
          "%.1f images/s, busy %s, peak allocated %.1f MB (%.1f MB above "
          "the %.1f MB allocated before the windows); %s" % (
              step_ms, len(windows), cfg["window"],
              [round(w, 3) for w in windows], cfg["batch"] / step_ms * 1e3,
              "not measured" if busy is None else
              "%.1f%%" % (100 * busy["busy_share"]), peak / 1e6,
              (peak - base) / 1e6, base / 1e6, card_line()))
    # detections from the trained weights, card against CPU
    images = {"img": batch["img"][:cfg["compare_batch"]]}
    cpu_scope = scope_copy(scope, "cpu")
    got = {"cpu": core.Executor(device="cpu").run(
        infer, feed=images, fetch_list=[dets], scope=cpu_scope)[0]}
    got["cuda"] = core.Executor(device="cuda").run(
        infer, feed=images, fetch_list=[dets], scope=scope)[0]
    a, b = got["cuda"], got["cpu"]
    kept = int((b[..., 0] >= 0).sum())
    err = float(np.abs(a[..., 1:] - b[..., 1:]).max() /
                max(float(np.abs(b[..., 1:]).max()), 1e-30))
    print("[detection] infer at batch %d: %s detections, %d kept; labels "
          "equal %s, scores and boxes rel err %.3g (tolerance %.0e)" % (
              cfg["compare_batch"], tuple(a.shape), kept,
              np.array_equal(a[..., 0], b[..., 0]), err, DETECT_RTOL))
    check(a.shape == b.shape == (cfg["compare_batch"], 16, 6) and kept and
          np.array_equal(a[..., 0], b[..., 0]) and err <= DETECT_RTOL,
          "[detection] infer card against CPU")
    fresh = core.Executor(device="cuda")
    dev_images = {"img": torch.from_numpy(images["img"]).cuda()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fresh.run(infer, feed=dev_images, fetch_list=[dets], scope=scope,
                  return_numpy=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    maps = {}
    for dev in ("cpu", "cuda"):
        ev = evaluator.DetectionMAP(cfg["classes"])
        ev.update(got[dev], *(small[k] for k in ("gb", "gl", "gc")))
        maps[dev] = ev.eval()
    print("[detection] DetectionMAP (11-point) over the %d images: card "
          "%.6f, CPU %.6f; a warm infer call read nothing back; %.1f s"
          % (cfg["compare_batch"], maps["cuda"], maps["cpu"],
             time.perf_counter() - t0))
    check(abs(maps["cuda"] - maps["cpu"]) <= DETECT_MAP_ATOL,
          "[detection] mAP card %r CPU %r" % (maps["cuda"], maps["cpu"]))
    return dict(step_ms=step_ms, peak=peak)


def vision_program(name, res, classes, seed, with_eval=False):
    """The ``benchmark/paddle/image`` recipe ``name`` at res², Momentum;
    with ``with_eval`` an ``evaluator.Accuracy`` over its softmax."""
    from paddle_tpu_torch import core, evaluator, layers, optimizer
    from paddle_tpu_torch.models import alexnet, googlenet, smallnet, vgg
    build = {"alexnet": alexnet.alexnet, "googlenet": googlenet.googlenet,
             "smallnet": smallnet.smallnet,
             "vgg19": lambda i, l, **k: vgg.vgg(i, l, depth=19, **k)}[name]
    main, startup = core.Program(), core.Program()
    startup.random_seed = seed
    ev = None
    with core.unique_name.guard(), core.program_guard(main, startup):
        img = layers.data("img", shape=[3, res, res])
        label = layers.data("label", shape=[1], dtype="int64")
        loss, acc, logits = build(img, label, class_dim=classes)
        if with_eval:
            ev = evaluator.Accuracy(layers.softmax(logits), label)
        optimizer.Momentum(VISION["lr"], VISION["momentum"]).minimize(
            loss, startup)
    return main, startup, loss, acc, ev


def phase_vision(seed):
    """[vision]: the ``benchmark/paddle/image`` recipes at ImageNet width
    (AlexNet, VGG-19, GoogLeNet at 224², 1000 classes; SmallNet at 3 x 32 x
    32, 10 classes), Momentum(0.01, 0.9), data from the seed: one step at
    batch 2 card against CPU from the same startup weights (``step_pair``:
    the loss, every parameter and velocity); 10 timed steps at batch 64
    from those weights (median step,
    images/s, one step's busy share, peak memory) beside the step's
    reckoned bound (f32 CUDA-core FLOPs and bytes); SmallNet's
    ``evaluator.Accuracy`` accumulated over its steps equal to the mean of
    their ``accuracy`` outputs."""
    import torch
    from paddle_tpu_torch import core
    cfg = VISION
    t0 = time.perf_counter()
    rows = {}
    for name, res, classes in VISION_MODELS:
        t1 = time.perf_counter()
        main, startup, loss, acc, ev = vision_program(
            name, res, classes, seed, with_eval=name == "smallnet")
        rs = np.random.RandomState(seed)
        small = {"img": rs.rand(cfg["compare_batch"], 3, res, res)
                 .astype(np.float32),
                 "label": rs.randint(0, classes, (cfg["compare_batch"], 1))
                 .astype(np.int64)}
        init = step_pair(main, startup, loss, small, VISION_RTOL,
                         "vision %s" % name)
        scope = scope_copy(init, "cuda")
        del init
        exe = core.Executor(device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(seed)
        feed = {"img": torch.rand((cfg["batch"], 3, res, res),
                                  generator=gen, device="cuda"),
                "label": torch.randint(0, classes, (cfg["batch"], 1),
                                       generator=gen, device="cuda")}
        for _ in range(cfg["warmup"]):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                    return_numpy=False)
        if ev is not None:
            ev.reset(scope=scope)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, accs, losses = [], [], []
        for _ in range(cfg["steps"]):
            t2 = time.perf_counter()
            lv, av = exe.run(main, feed=feed, fetch_list=[loss, acc],
                             scope=scope, return_numpy=False)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t2) * 1e3)
            losses.append(float(lv))
            accs.append(float(av))
        peak = torch.cuda.max_memory_allocated()
        step_ms = float(np.median(times))
        # the evaluator's state before the profiled step adds a batch
        ev_acc = ev.eval(scope=scope) if ev is not None else None
        busy = profile_window("vision %s one training step" % name,
                              lambda: exe.run(main, feed=feed,
                                              fetch_list=[loss], scope=scope,
                                              return_numpy=False))
        flops, nbytes, params = program_work(main, cfg["batch"])
        bound, bound_by = roofline_ms(nbytes, flops)
        print("[vision] %s %d² batch %d: step %.3f ms (median of %d: %s), "
              "%.1f images/s, busy %s, peak allocated %.1f MB; bound %.3f "
              "ms (%s: %.1f GFLOP f32, %.1f MB, %d parameters), %.3f of "
              "the step; losses %.4f -> %.4f (%d of %d finite); %.1f s; "
              "%s" % (
                  name, res, cfg["batch"], step_ms, cfg["steps"],
                  [round(t, 3) for t in times], cfg["batch"] / step_ms * 1e3,
                  "not measured" if busy is None else
                  "%.1f%%" % (100 * busy["busy_share"]), peak / 1e6, bound,
                  bound_by, flops / 1e9, nbytes / 1e6, params,
                  bound / step_ms, losses[0], losses[-1],
                  int(np.isfinite(losses).sum()), len(losses),
                  time.perf_counter() - t1, card_line()))
        # Momentum(0.01, 0.9) on random labels may diverge (VGG-19 does in
        # a CPU rehearsal): the timed steps are timed, not trained
        check(np.isfinite(losses[0]), "[vision] %s losses %s"
              % (name, losses))
        if ev is not None:
            got, want = ev_acc, float(np.mean(accs))
            print("[vision] smallnet Accuracy evaluator over the %d steps "
                  "%.6f, mean of the steps' accuracy %.6f" % (
                      cfg["steps"], got, want))
            check(abs(got - want) <= 1e-9, "[vision] Accuracy %r against "
                  "%r" % (got, want))
        rows[name] = dict(step_ms=step_ms, peak=peak, bound_ms=bound)
        del exe, scope, feed
        gc.collect()
        torch.cuda.empty_cache()
    print("[vision] done in %.1f s" % (time.perf_counter() - t0))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    try:
        from paddle_tpu_torch import resolve_device
        from paddle_tpu_torch.io import params_from_jax
        from paddle_tpu_torch.models.transformer import \
            transformer_lm_session
        from paddle_tpu_torch.serving import GenerationSession
    except ImportError as exc:
        print("FAIL: paddle_tpu_torch not importable: %s" % exc,
              file=sys.stderr)
        return 1
    # TF32 off for matmuls and cuDNN convolutions before the first one:
    # the plain versions are held to full f32
    resolve_device("cuda")
    torch.manual_seed(args.seed)    # the tensors made on the card
    rng = np.random.default_rng(args.seed)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print("[device] %s (%d visible), torch %s, CUDA %s; TF32 matmul %s, "
          "cuDNN %s" % (torch.cuda.get_device_name(0),
                        torch.cuda.device_count(), torch.__version__,
                        torch.version.cuda,
                        torch.backends.cuda.matmul.allow_tf32,
                        torch.backends.cudnn.allow_tf32))
    try:
        phase_build()
        errs = phase_compare(rng)
        errs["decode_attention_paged"] = phase_compare_paged(rng)
        errs.update(phase_compare_bf16(rng))
        # B5's split boundaries draw from a stream of their own, so the
        # phases after see the inputs they saw before these existed
        splits = phase_compare_paged_splits(
            np.random.default_rng(args.seed + 4))
        errs["decode_attention_paged"] = max(
            errs["decode_attention_paged"], splits["float32"])
        errs["decode_attention_paged bf16"] = max(
            errs["decode_attention_paged bf16"], splits["bfloat16"])
        # and B5 at the verify forward's shape, from another
        verify = phase_compare_paged_verify(
            np.random.default_rng(args.seed + 7))
        errs["decode_attention_paged"] = max(
            errs["decode_attention_paged"], verify["float32"])
        errs["decode_attention_paged bf16"] = max(
            errs["decode_attention_paged bf16"], verify["bfloat16"])
        # and B4's, from another
        dense = phase_compare_dense_splits(
            np.random.default_rng(args.seed + 5))
        errs["decode_attention"] = max(errs["decode_attention"],
                                       dense["float32"])
        errs["decode_attention bf16"] = max(errs["decode_attention bf16"],
                                            dense["bfloat16"])
        errs["int8_matmul"] = phase_compare_int8(
            rng, np.random.default_rng(args.seed + 3))
        errs.update(phase_compare_conv_bn(rng))
        errs["flash_attention bf16"] = phase_compare_flash_bf16()
        sweep = phase_compare_flash_sweep()
        phase_compare_flash_backward()
        phase_small_lm(rng)
        phase_small_lm_paged(rng)
        b4_bf16_launches = phase_small_lm_quant(rng)
        phase_small_resnet(rng)
        phase_small_resnet_amp(np.random.default_rng(args.seed + 2))
        phase_small_program(args.seed)
        phase_small_program_int8(args.seed)
        phase_small_program_lm(args.seed)
        phase_small_program_serve(args.seed)
        # the LeNet-5/MNIST slice: the op library card against CPU, and
        # LeNet-5's training
        phase_ops()
        phase_ops_rnn(args.seed)
        phase_ops_tail()
        phase_lenet(args.seed)
        gc.collect()
        torch.cuda.empty_cache()
        # the op tail's models: SSD, and the image recipes at ImageNet
        # width
        phase_detection(args.seed)
        gc.collect()
        torch.cuda.empty_cache()
        phase_vision(args.seed)
        gc.collect()
        torch.cuda.empty_cache()
        # the distribution slice: BASELINE config 5 and the strategy route
        phase_recsys(args.seed)
        gc.collect()
        torch.cuda.empty_cache()
        dist_b2 = phase_dist(args.seed)
        gc.collect()
        torch.cuda.empty_cache()
        # the RNN and seq2seq slice: control flow, BASELINE configs 4 and
        # 3, and the uncached LM generation over B2
        phase_control_flow(args.seed)
        phase_seq2seq(args.seed)
        gc.collect()
        torch.cuda.empty_cache()
        lstm_sent = phase_lstm_sentiment(args.seed)
        gc.collect()
        torch.cuda.empty_cache()
        # the v2 API: the same widths through paddle.v2's SGD
        phase_v2(args.seed, lstm_sent["step_ms"])
        gc.collect()
        torch.cuda.empty_cache()
        generate_b2 = phase_lm_generate(args.seed)
        gc.collect()
        torch.cuda.empty_cache()
        # the LM training phases draw from their own stream, so the
        # serving phases see the inputs they saw before these existed
        lm_rng = np.random.default_rng(args.seed + 1)
        phase_small_lm_train(lm_rng)
        t0 = time.perf_counter()
        named = make_params(FULL, rng)
        params = params_from_jax(named, device="cuda")
        del named
        spec = transformer_lm_session(
            slots=SLOTS, cache_len=CACHE_LEN, prompt_buckets=BUCKETS,
            eos_id=1, device="cuda", **FULL)
        sess = GenerationSession(spec, params)
        paged_kw = dict(slots=SLOTS, cache_len=CACHE_LEN,
                        prompt_buckets=BUCKETS, eos_id=1, device="cuda",
                        paged=True, block_size=BLOCK_SIZE, num_blocks=0,
                        prefix_cache=True, **FULL)
        paged = GenerationSession(transformer_lm_session(**paged_kw), params)
        t1 = time.perf_counter()
        quant = GenerationSession(
            transformer_lm_session(dtype="bfloat16", **paged_kw), params,
            arm_quant=True)
        arm_s = time.perf_counter() - t1
        del params
        torch.cuda.synchronize()
        nparam = sum(p.numel() for p in sess.model.parameters())
        print("[weights] %d parameters (%.2f GB f32) made and loaded into "
              "a dense, a paged and an int8/bf16 paged session in %.1f s "
              "(building and arming the int8 one: %.1f s)"
              % (nparam, nparam * 4 / 1e9, time.perf_counter() - t0, arm_s))
        launches, final, dense_prompts, dense_outs = phase_serve(sess, rng)
        system, prompts = paged_prompts(rng)
        paged_launches, paged_outs, paged_final, paged_peak = \
            phase_paged_serve(paged, prompts)
        launches["decode_attention_paged"] = \
            paged_launches["decode_attention_paged"]
        quant_launches, _, quant_outs = phase_quant_serve(
            quant, paged, prompts, paged_outs)
        phase_paged_logits(paged, sess, system, rng)
        # serving through the programs, on the same weights; its timing
        # prompts from a stream of its own
        prog_serve = phase_program_serve(
            sess, paged, quant, dense_prompts, dense_outs, prompts,
            paged_outs, quant_outs, paged_peak,
            np.random.default_rng(args.seed + 10))
        gc.collect()
        torch.cuda.empty_cache()
        phase_program_generation(args.seed)
        # the decode policies draw from a stream of their own, so the
        # phases after see the inputs they saw before these existed
        pol_rng = np.random.default_rng(args.seed + 6)
        phase_compare_sample(pol_rng)
        pol = policy_sessions(sess, paged, quant, paged_kw)
        sample_outs = phase_sample_serve(pol["sample"], prompts)
        phase_spec_serve(pol["spec"], prompts, paged_outs, paged,
                         "spec-serve")
        phase_spec_serve(pol["spec sample"], prompts, sample_outs, paged,
                         "spec-serve sample", seeds=SAMPLE_SEEDS)
        phase_spec_serve(pol["spec full draft"], prompts, paged_outs, paged,
                         "spec-serve full draft", accepting=True)
        phase_spec_serve(pol["spec int8"], prompts, quant_outs, quant,
                         "spec-serve int8", int8=True)
        phase_spec_serve(pol["spec int8 full draft"], prompts, quant_outs,
                         quant, "spec-serve int8 full draft", int8=True,
                         accepting=True)
        _, top2_outs, _ = serve_paged(pol["sample top2"], prompts,
                                      "sample-serve top-2",
                                      seeds=SAMPLE_SEEDS)
        phase_spec_serve(pol["spec sample full draft"], prompts, top2_outs,
                         paged, "spec-serve sample full draft",
                         seeds=SAMPLE_SEEDS, knobs=SPEC_SAMPLE_KNOBS,
                         accepting=True)
        phase_constrain_serve(pol["constrain"], pol["constrain sample"],
                              pol["dead end"], prompts)
        phase_failover(paged, quant, prompts, paged_outs, sample_outs,
                       quant_outs, paged_kw, smi)
        # the telemetry plane's HTTP server beside the paged session
        phase_telemetry_serve(paged, prompts, paged_outs)
        phase_latency(sess, rng)
        phase_paged_latency(paged, sess, system, rng, quant)
        phase_policy_latency(sess, paged, pol, pol_rng)
        phase_profile(sess, rng, paged, system, quant)
        phase_profile_sampling(pol["sample"], pol_rng)
        for p in pol.values():
            p.close()
        del pol
        rows = phase_time(rng, launches, errs, final, paged_final,
                          quant_launches, b4_bf16_launches,
                          np.random.default_rng(args.seed + 8))
        paged.close()
        quant.close()
        print("[memory] peak allocated %.2f GB (serving phases)"
              % (torch.cuda.max_memory_allocated() / 1e9))
        # the LM's weights and caches leave the card before training
        sess.close()
        del sess, paged, quant
        gc.collect()
        model, opt, img, label, shapes, train_launches, train_stats = \
            phase_train(args.seed)
        phase_profile_train(model, opt, img, label)
        del model, opt, img, label
        gc.collect()
        torch.cuda.empty_cache()
        rows += phase_time_conv_bn(train_launches, errs, shapes)
        # the program path: ResNet-50 as bench.py builds and runs it
        phase_program_train_fused(args.seed, train_stats)
        gc.collect()
        plain = phase_program_train(args.seed)
        gc.collect()
        phase_program_train_recompute(args.seed, plain)
        del plain
        gc.collect()
        # bench.py's staged input pipeline through Trainer.train
        pipeline = phase_pipeline(args.seed)
        gc.collect()
        torch.cuda.empty_cache()
        # the training supervisor, the elastic control plane and the
        # telemetry plane over [pipeline]'s configuration
        t0 = time.perf_counter()
        resilient = phase_resilient(args.seed)
        phase_elastic(args.seed, resilient)
        phase_telemetry(args.seed, resilient)
        print("[resilient] [elastic] [telemetry] %.1f s together"
              % (time.perf_counter() - t0))
        del resilient
        gc.collect()
        torch.cuda.empty_cache()
        # ResNet-50 has left the card: the LM's training step, amp bf16
        with amp_flag("bfloat16"):
            model, opt, tokens, lm_launches, lm_stats = phase_lm_train(
                args.seed, lm_rng)
            phase_profile_lm_train(model, opt, tokens)
        del model, opt, tokens
        gc.collect()
        torch.cuda.empty_cache()
        # the LM through the program path, as bench.py runs it
        prog_lm = phase_program_lm_train(args.seed, lm_stats)
        gc.collect()
        torch.cuda.empty_cache()
        int8_shapes = phase_program_lm_int8(args.seed)
        gc.collect()
        torch.cuda.empty_cache()
        # inference export and the serving engine, from a stream of its own
        engine = phase_engine(args.seed, smi,
                              np.random.default_rng(args.seed + 11))
        gc.collect()
        torch.cuda.empty_cache()
        # the compile cache across processes and AOT serving artifacts
        phase_aot(args.seed, smi, np.random.default_rng(args.seed + 12))
        gc.collect()
        torch.cuda.empty_cache()
        # the fleet tier: the flagship LM served by member processes on
        # this card through a router
        fleet = phase_fleet()
        paging = phase_model_paging(fleet)
        paging["fleet_launches"] = fleet["launches"]
        del fleet
        gc.collect()
        torch.cuda.empty_cache()
        phase_captures()
        rows += phase_time_flash_bf16(lm_launches,
                                      errs["flash_attention bf16"], sweep)
        for row in rows:
            if row["name"] == "conv_bn_stats":
                # B1's launches over [pipeline]'s timed pass, all shapes
                row.update(pipeline_launches=pipeline["launches"],
                           pipeline_launches_in="[pipeline], 16 steps at "
                           "batch 8, every shape")
            if row["name"] == "flash_attention" and \
                    row.get("dtype") == "bfloat16":
                row.update(program_launches=prog_lm["launches"][
                    "flash_attention bf16"],
                    program_launches_in="[program-lm-train]",
                    dist_launches=dist_b2["flash_attention bf16"],
                    dist_per_shard=dist_b2["per_shard"],
                    dist_launches_in="[dist], the LM program under a "
                    "DistStrategy, per shard")
            if row["name"] in ("flash_attention", "decode_attention",
                               "decode_attention_paged",
                               "int8_matmul") and \
                    row.get("dtype", "float32") == "float32":
                # the same kernels under the generation programs' ops
                key = row["name"] + (
                    " bf16" if row.get("kv_dtype") == "bfloat16" else "")
                if key in prog_serve:
                    row.update(serve_program_launches=prog_serve[key],
                               serve_program_launches_in="[program-serve]")
            if row["name"] == "flash_attention" and \
                    row.get("dtype", "float32") == "float32":
                # B2 f32 under transformer_lm_generate's step sub-block
                row.update(generate_launches=generate_b2,
                           generate_launches_in="[lm-generate], a beam-4 "
                           "call: 4 layers x 64 steps")
            if row["name"] in ("flash_attention", "decode_attention") \
                    and row.get("dtype", "float32") == "float32" and \
                    row.get("kv_dtype", "float32") == "float32":
                # the fleet members' launches, as their LAUNCHES lines
                # counted them: 12 an admission (B2), 12 a decode step (B4)
                row.update(
                    fleet_launches=paging["launches"][row["name"]] +
                    paging["fleet_launches"][row["name"]],
                    fleet_launches_in="[fleet] and [model-paging], the "
                    "members that stopped (m0 was SIGKILLed)")
            if row["name"] in engine and \
                    row.get("dtype", "float32") == "float32":
                # the serving engine's launches over [engine]: 12 (B2 f32)
                # and 73 (B3, the int8 engine) an execution
                row.update(engine_launches=engine[row["name"]],
                           engine_launches_in="[engine]")
            if row["name"] == "int8_matmul" and \
                    row["shape"][0] == PROGRAM_INT8_T:
                # the armed run's launches of this shape, as B3's wrapper
                # counted them
                row.update(program_launches=int8_shapes.get(
                    tuple(row["shape"]), 0),
                    program_launches_in="[program-lm-int8], one run")
    except SmokeFailure as exc:
        print("FAIL: %s" % exc, file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows}))
    print(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
