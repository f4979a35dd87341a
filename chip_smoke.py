#!/usr/bin/env python3
"""Drive the PyTorch port (ray_tpu_torch) on one CUDA card and check it.

Run from the root of a checkout, on a machine with an NVIDIA card, nvcc
and PyTorch built for CUDA:

    python3 chip_smoke.py

Every phase prints one JSON line and any failure exits nonzero:

  device   torch's device name; nvidia-smi's name and power limit (also
           printed raw, as nvidia-smi gives them)
  build    nvcc seconds and the ptxas register/spill/warning lines of each
           source; for each redesigned kernel (the bf16 splash forward, dq
           and dk/dv and the bf16 flash forward, dq and dk/dv, each at head
           dims 64 and 128: twelve instantiations) its registers and
           spills, whether ptxas ignored setmaxnreg (C7508), and whether
           its SASS (cuobjdump -sass) holds HGMMA (wgmma) and UTMALDG (TMA
           loads);
           the phase fails if one is missing, lacks either, spills, or
           setmaxnreg was ignored
  kernel   the flash kernel against its plain version run in f32 on the
           same seeded inputs: the forward's shape (bf16, causal,
           [4,12,1024,64] bnsh), non-causal, bsnh, f32, ragged tails, the
           other head dims, ragged S at the wgmma kernels' head dims, and
           the training call ([32,12,1024,64] bf16 causal, q/k/v strided
           views of one fused qkv tensor)
  kernel_bwd  the backward kernels (dq; dk and dv) against the plain
           backward run in f32 on the same seeded q, k, v, dO, over the
           same cases (dO contiguous): max |err| <= tol x max |ref| per
           tensor
  forward  GPT-2-small [4, 1024], attention="flash": f32 logits against
           the dense forward; bf16 top-1 against the f32 forward, as close
           as the dense bf16 forward's; exactly 12 kernel launches per
           forward; ms per forward and tokens/s; a profile of one forward
           (device time by kernel, idle share)
  serve    the paged engine answering 12 requests of 32..512 prompt tokens
           with 8 slots (admission queues): in f32 three streams equal the
           dense forward's greedy tokens; in bf16 throughput and time to
           first token, and a profile of one full decode step; every page
           returned
  train    GPT-2-small training at full width (MFU from bench.py's count,
           6 N + 12 L S D per token over 989e12): (a) f32 loss and grads
           with flash against dense at [2, 1024]; (b) bf16 flash grads as
           close to the f32 dense grads as the bf16 dense grads are (per
           leaf: relative distance ||g - g32|| / ||g32|| and cosine);
           (d) flash launches of one step under the
           remat policies full, attn, attn_dots; (c) bench.py's
           configuration (B=32, S=1024, bf16, remat "dots", ce_block 256,
           AdamW 3e-4 b2 0.95 wd 1e-4): 1 warm and 8 timed steps on one
           batch, loss finite and falling, exact launches per step, ms per
           step, samples/s, tokens/s, MFU; (e) a profile of one step
  top1_trained  the bf16 top-1 check on trained weights: GPT-2-small (the
           train phase's configuration) trained 300 AdamW steps (1e-3
           after 30 warmup steps) on batches of 8 windows of 1024 bytes of
           the repository's *.md files (the first 90%) and 8 windows of a
           copy corpus made from a seed (spans of 64 bytes drawn from a
           Zipf law, each followed by its copy); then, on each corpus's 8
           held-out windows (the last 10% of the text; fresh copy windows):
           the f32 forward's cross-entropy beside two context-free
           baselines (unigram and bigram byte frequencies of the training
           part), bf16 top-1 agreement of flash with dense and of each with
           the f32 dense forward, beside the forward phase's figures on
           random weights, and the share of positions whose top-2 gap is
           under the bf16 logit error; "c1_closed" when, on the copy
           corpus, flash and dense agree on 99% and the held-out loss is
           0.3 nats under the better baseline; flash no further from f32
           than dense less half a point on both
  llama_forward, llama_serve, llama_train_check, llama_train
           the same four phases (and their profiles) on LLaMA-125M (12
           layers, 12 query and 4 KV heads of 64, SwiGLU 2048, vocab 32000,
           untied head): the forward [4, 1024] with flash (K/V repeated to
           the query heads for the kernels), the engine with model="llama"
           under the serve phase's traffic, and training at bench.py's
           _llama_point (B=32, S=1024, bf16, remat "dots", ce_block 256,
           AdamW 3e-4 b2 0.95 wd 1e-4), under the same limits and exact
           launch counts as GPT's
  moe_train_check, moe_train
           MoE GPT-2-small (GPT-2-small's widths with 8 experts of 3072 in
           every layer, top-2, capacity factor 1.25, aux coefficient 0.01:
           Switch-Base-8's widths) under GPT's training checks and at
           bench.py's configuration, launches 24/12/12 a step as GPT's;
           MFU counted twice, by the params a token uses (model) and by
           every capacity slot plus the dispatch and combine einsums
           (executed), both formulas printed; the aux loss per layer and
           the share of routed (token, choice) pairs dropped over capacity
           on the check batch; a profile of one step
  dist_single  the parallel layer in a one-rank NCCL world (FileStore in
           a temporary directory): MeshSpec().build() on cuda, shard_params
           of GPT-2-small, one sharded AdamW step with flash under the mesh
           against the same step unsharded (bf16, [8, 1024]), each
           collective once, ring attention at sp=1 on [4,12,1024,64] bf16
           against plain causal attention, make_ring_attention_fn refusing
           sp=1
  pipeline  the pipeline (parallel/pipeline.py) in the same one-rank NCCL
           world (pp = 1: every microbatch through the one stage): an f32
           rehearsal of GPipe and 1F1B against gpt_loss at a small config
           (loss 1e-5 relative, grad leaves 1e-4 of their max); then
           GPT-2-small bf16 flash, full remat in the stages, the
           full-logit head, [32, 1024] in 8 microbatches of 4: the
           unpipelined, GPipe and 1F1B steps from one init, their first
           loss and grad norm within DIST_RTOL of the unpipelined step's
           and each grad leaf within PIPE_LEAF_RTOL (relative distance),
           exact launches (24/12/12 and 192/96/96 a step), ms per step
           (each of 4 timed steps), tokens/s and peak memory, and each
           step's device time by kind of kernel and idle share
  kernel_splash  the three splash kernels (forward; dq; dk and dv) against
           their plain versions run in f32: Llama 2 7B's attention
           [2,32,4096,128] bf16 causal at 128-blocks, [1,2,256,*] with
           partial, empty and full blocks (bf16, f32, H 64 and 128), one
           map per head with unequal blocks (f32 at H 64, bf16 at H 128),
           and [2,4,1024,128] at every candidate block size of the sweep
  autotune the autotune path under a fresh cache file ($RT_AUTOTUNE_CACHE
           set to a temporary file): tune_attention at (a) GPT-2-small's
           training attention [B=32,S=1024,N=12,H=64] (flash and dense
           timed, splash absent) and (b) [2,4096,32,128] (all 9 splash
           candidates, flash and dense); every record read back by a fresh
           cache; dispatch.attention with no variant runs each recorded
           winner, as the launch counters show; the model's
           attention="auto" takes the record; then the bf16 grads of the
           splash variant at (b) no further from the f32 dense grads than
           REL_MULT x the bf16 dense grads' distance
  attention_shapes  device times of the bf16 flash forward (causal and
           not), the splash forward and dq, and SDPA's forward at
           GPT-2-small's inference and training calls, a long sequence
           ([2,12,8192,64]) and shape (b)
  kernels  per kernel: its time, its plain version's, one library call's
           (scaled_dot_product_attention's forward, or its backward timed
           as forward+backward less forward: a yardstick the port never
           calls), the least time the card could take, its launches on
           the main paths (forward and serve for the forward kernel, the
           timed training steps for the flash kernels, the autotune path
           for the splash kernels; the flash entries also each family's
           inference and training launches, MoE GPT's training and the
           pipeline's two schedules, the serve replica's batched
           forward and the cluster paths' actors among them), its error
           and its bf16 design ("wgmma+tma" or "mma.sync"); all but the
           flash forward's entry also their achieved TFLOP/s and the share
           of their bound they reach (the flash forward's under
           "train_call" and at the inference call); the flash backward's
           library time is SDPA's backward by device time, its event time
           beside it; the flash forward is timed at the inference call
           [4,12,1024,64] and at the training call [32,12,1024,64], each
           with the device time
           of scaled_dot_product_attention's forward beside its event time;
           a kernel's device time counts its events in the trace and, when
           fewer than the calls' launches came back, is taken between CUDA
           events instead (a profiler_miss line says so); a time under its
           bound (share above MAX_BOUND_SHARE) fails the phase

  runtime  the port's runtime core on the card, after the other phases
           (cache emptied): the free size of /dev/shm (the phase fails
           when it cannot hold the 2 GiB store); init(num_cpus=4) and its
           resources (GPU: 1 and accelerator_type:H100, found by the
           daemon with no override); GPT-2-small's f32 params put as a
           numpy tree, a num_gpus=1 actor built on them (its
           CUDA_VISIBLE_DEVICES, cold start split into torch import, CUDA
           init and params), the bf16 flash forward on [2, 1024] tokens
           from seed 0 in the actor (its own launch counts: exactly 12
           flash forward launches a forward, nothing else) and its logits
           back as a CUDA tensor, bit-identical to the in-process forward
           (else within the in-process bf16-against-f32 error); a second
           num_gpus=1 actor waits while the first lives and, after the
           first is killed, gives the same logits; a num_gpus=0 task sees
           CUDA_VISIBLE_DEVICES="" and gets the logits as an equal CPU
           tensor; put/get GB/s of the params and the logits, the empty
           task round trip, init seconds; after shutdown no segment of
           the session is left
  runtime_observe  the observers on that cluster: the "actors" pubsub
           channel (subscribed before the first GPU actor starts) gives
           the first actor's alive event before its dead one; a forward
           under a driver span comes back from get_spans as the parent of
           the actor's span; one forward with attention="auto" in the
           actor, whose autotune counters reach autotune_totals() (the
           driver's plus the actor's) through the metrics sink;
           list_actors() shows both GPU actors (first DEAD, second ALIVE,
           GPU: 1), list_tasks(name="forward") one FINISHED call and
           timeline() one "X" event per forward call, each at least the
           actor's own ms; the card in list_nodes(), node_stats() and
           cluster_summary(); the wall ms of each observer call
  runtime_node_death  a num_gpus=1 GPT actor (max_restarts=1) on a
           cluster_utils.Cluster: a head with no card (its GCS given a
           5 s reconnect grace) and a worker node given the card;
           NodeKiller SIGKILLs the worker node and wait_node_dead sees
           it; every process of the dead node exits and none holds the
           card (nvidia-smi's compute apps, memory.used falling by at
           least the actor's reserved memory); a new node with the card
           joins and the actor restarts there with logits bit-identical to
           its logits before the kill; seconds to detect, to free the card
           and to restart (torch import, CUDA init and params split out)
  runtime_serve  serve on the same cluster, after the GPU actors are
           gone: (a) an LLMServer replica with num_gpus=1 (GPT-2-small,
           bf16, the serve phase's engine settings; its params pulled from
           the store in __init__, its cold start split into process start
           to __init__ (interpreter, worker connect, the unpickle that
           imports torch), params and engine build) streams the serve
           phase's 12 prompts over HTTP (SSE, all at once) through
           serve.start_http(); every stream's 64 tokens equal an
           in-process engine's on the same params and prompts (a
           divergence is accepted only where the two tokens' bf16 logits
           lie within the in-process bf16 error, and is printed); tokens/s
           and p50 time to first token beside the in-process engine's
           and the serve phase's; one request alone on the replica's own
           engine, through the handle and over HTTP (the differences are
           the per-request overheads); /api/serve
           shows the deployment running, every node's stats carry the
           serve counters, and serve_totals() (failures only: it has no
           request counter) and the ingress count no retry, ejection,
           resume, drain or shed; after
           serve.delete the replica's process leaves nvidia-smi's compute
           apps; (b) a num_gpus=1 replica whose @serve.batch(4) method
           runs the bf16 flash forward on rows of 1024 tokens answers 8
           concurrent handle calls with last-position logits as CPU
           tensors, each within the runtime phase's limit of the
           in-process forward of its row; its own launch counts (12
           flash forward launches a batch, nothing else) are the kernels
           line's launches_serve
  runtime_train  train on the same cluster, after serve has given the
           card back: GPT-2-small at phase_train's settings ([32, 1024],
           bf16 over f32 params, flash, remat dots, ce_block 256, AdamW
           3e-4, b2 0.95, wd 1e-4; weights from seed 0, step k's tokens
           from seed 1000 + k) trained by TorchTrainer with one
           num_gpus=1 worker, which must see exactly the card; two fits
           of 12 steps, each checkpointing every 4 steps through
           CheckpointStore and AsyncCheckpointWriter (params + AdamW
           state + RNG states + the data cursor) and reporting each step
           through session.report: the control, and the recovery run,
           whose worker is SIGKILLed by kill_train_worker after step 9's
           report (once step 8's checkpoint is committed) and recovered
           by FailureConfig(max_failures=1) onto a new num_gpus=1 worker
           that restores step 8 and runs steps 9-12; the recovery's
           losses at steps 9-12 and its final params' sha256 equal the
           control's bit for bit; the card is
           free after each fit; the worker's cold start, ms/step (median
           of steps 2-8, the step and its loss's one sync) beside
           phase_train's in-process ms/step, the checkpoint's bytes, the
           snapshot stall on the step loop, the async write, the restore
           and kill-to-next-step seconds; the flash launches counted in
           the workers' own processes (exactly 24/12/12 a step) are the
           kernels line's launches_runtime_train
  runtime_data  train from a Dataset on the same cluster, after
           runtime_train: 16 blocks of 32 windows of [32, 1024]'s length
           plus the target token (tokens from seed 2000), from_numpy and
           random_shuffle(seed=0), which is push-based at 16 blocks; a
           TorchTrainer with one num_gpus=1 worker and datasets={"train":
           ds} trains GPT-2-small at phase_train's settings (weights from
           seed 0), one step per batch of get_dataset_shard("train")
           .iter_device_batches(batch_size=32) (pinned staging buffers, a
           side stream, the next copy in flight during the step); each
           step reports its loss, the sha256 of its tokens and how long
           the loop waited for the batch; the hashes equal those of the
           same Dataset read on the driver with iter_batches(batch_size=
           32), the losses equal an in-process run from the same init on
           those batches (within DATA_LOSS_RTOL; whether bit-identical is
           printed), the flash launches counted in the worker are exactly
           24/12/12 a step (the kernels line's launches_runtime_data);
           ms/step (median of steps 2-16) beside runtime_train's steps
           with no checkpoint write in flight, the ingest wait per step,
           the host-to-device bytes and GB/s, the shuffle's seconds and
           the worker's cold start
  runtime_tune  tune on the same cluster, after runtime_data: Tuner over
           a TorchTrainer with one num_gpus=1 worker training GPT-2-small
           at phase_train's settings (weights from seed 0, step k's
           tokens from seed 1000 + k), lr grid_search over TUNE_LRS in
           that order, ASHAScheduler(max_t=8, grace_period=2,
           reduction_factor=2), max_concurrent_trials=1 (the one card);
           the worker reports each step (one training_iteration) and
           never "done", the step-8 report with the params' sha256 and a
           host checkpoint of them; first the same steps in this process
           at each rate and a fresh ASHAScheduler's decisions on those
           losses in grid order; every trial's losses bit-identical to the
           in-process run's, the runner's stop iterations the replay's (one
           trial at least stopped before max_t), get_best_result() the
           rate the in-process losses make best and its checkpoint, read
           on the driver, hashing to the in-process params; each trial's
           worker sees exactly the card, the runtime's actor table shows
           at most one live actor holding the card at any sample (every
           0.25 s; nvidia-smi lists the card's processes as one pid), and
           after every trial's stop the card comes back (the GPU resource
           and memory.used within CARD_MIB_SLACK of the sweep's start,
           waited for inside the runner's stop); each trial's
           flash launches exactly 24/12/12 a step (the kernels line's
           launches_runtime_tune); per trial its cold start (trial start
           to the worker ready to step), ms/step beside runtime_train's
           write-free steps and the stop's seconds; between trials the gap
           from the stop to the next worker's loop start, split into the
           stop, the card's return and the next trial's start; Tune's
           saves of the best trial's checkpoint (bytes, seconds) and the
           driver's read and hash of it
  runtime_rllib  RLlib on the same cluster, after runtime_tune: the
           learner (the algorithm's local policy) in this process on the
           card, the rollout workers card-less actors (num_cpus only,
           device="cpu").  PPO at tests/test_rllib.py:216-236's config
           (CartPole-v1, 2 remote workers x 8 envs, fragment 64, lr 5e-4,
           num_sgd_iter 6, sgd_minibatch_size 256, entropy_coeff 0.005,
           seed 0) for RLLIB_PPO_ITERS train() calls: the last
           episode_reward_mean above the first by more than 10 (the JAX
           package's bar); the first update's batch through a CPU
           PPOPolicy from the same weights gives the card's
           first-minibatch total loss within RLLIB_LOSS_RTOL and every
           grad leaf within RLLIB_GRAD_RTOL of the leaf's max |g|; after
           sync_weights every remote worker's weights hash to the
           learner's; the workers see CUDA_VISIBLE_DEVICES "" and the
           runtime's actor table shows no live actor holding the card at
           any sample.  IMPALA at tests/test_rllib_dqn_impala.py:94-105's
           config (1 remote worker x 4 envs, fragment 16,
           num_batches_per_step 2, 2 steps): num_updates rises, the
           losses are finite, its loader lands the batches on the card,
           and its first update matches the CPU's as PPO's does.  Ape-X
           DQN at tests/test_rllib_apex.py:14-19's config (CartPole-v1,
           3 remote workers x 4 envs, fragment 4, 2 card-less replay
           shard actors, lr 1e-3, learning_starts 500, 16 updates a
           train() call, target sync every 60 updates, broadcast every 2,
           seed 0) for RLLIB_APEX_ITERS train() calls: num_updates 16 a
           call, finite losses, the epsilon ladder of the reference test
           (3 rungs, 0.4 first, under 0.01 last, falling), every shard
           holding experience and seeing CUDA_VISIBLE_DEVICES "", the
           workers' weights hashing to the learner's after a broadcast,
           no live actor holding the card, and the first update's loss
           and grads matching a CPU DQNPolicy from the same weights and
           batch.  SAC at tests/test_rllib_dqn_impala.py:178-184's config
           (Pendulum-v1, the local worker sampling on the card) for
           RLLIB_SAC_STEPS steps and QMIX at tests/test_rllib_qmix.py:
           18-22's (TwoStepGame-v0, qmix mixer, full exploration) for
           RLLIB_QMIX_STEPS steps: finite losses, the first update
           against the CPU from the same weights, batch and noise (SAC's
           critic loss within RLLIB_LOSS_RTOL relative, its actor loss,
           alpha and entropy within it of max(|x|, 1)).  After every
           algorithm's stop its actors are gone and the card's allocated
           memory is back to its reading before the step and memory.used
           within CARD_MIB_SLACK.  Prints the workers' cold start (Ape-X's
           3 workers and 2 shards answering), sample s and weight-sync ms
           per iteration, the learner's ms per update on the card beside
           the same update on the CPU in this process, IMPALA's loader
           wait per batch, Ape-X's shard.sample round trip per update and
           harvest ms per train() call, QMIX's ms per episode (one greedy
           forward on the card a step) and each algorithm's wall time
  runtime_cluster  the cluster layer and tools, after runtime_node_death
           (every cluster shut down), each path running GPT-2-small's bf16
           flash forward on [4, 1024] tokens from seed 0 in a num_gpus=1
           GPTActor (weights from seed 0) whose logits must hash to the
           in-process forward's and whose own launch counts must be
           exactly 12 flash forward launches: (a) `python -m ray_tpu_torch
           start --head` in a private RT_SESSION_DIR, whose `status`
           shows GPU: 1 and an H100 accelerator_type; `job submit --wait`
           of an entrypoint (this script's cluster_job_main) shipped in a
           working_dir runtime env, which joins through RT_ADDRESS, must
           see no card (torch.cuda.is_available() False) and gets the
           logits on the CPU, its output the same through `job logs`; a
           second job whose CardHolder actor holds 1 GiB of the card,
           stopped with `job stop` (its SIGTERM handler kills the holder:
           actors outlive their driver), status STOPPED; `list actors`
           shows no live actor on the card; `stop` ends every daemon;
           (b) a client proxy (util.client.start_proxy) on a head, and a
           client in a separate process that sees no card
           (cluster_client_main): connect, the actor through the session
           (which must see CUDA_VISIBLE_DEVICES ""), its logits back as a
           CPU tensor, then kill and disconnect(end_session=True): the
           session process gone, the actor dead; (c) a cluster_utils
           Cluster head with no card, a LocalNodeProvider and a Monitor
           with one node type gpu1 = {CPU: 4, GPU: 1} (min 0, max 1, idle
           timeout CLUSTER_IDLE_S): the queued actor makes it launch the
           node, the actor answers there, and once it is killed the idle
           node is ended; after each path the card's memory.used is back
           within CARD_MIB_SLACK of its reading before the step; prints
           the head start, job submit-to-running and end-to-end, client
           connect and logits get, demand-to-launch, launch-to-first-
           answer and idle-to-terminate times; (d) `python -m
           ray_tpu_torch._private.microbenchmark --quick`, one line a
           metric with the card beside it (host numbers: CPU workers)
  total    the script's seconds

The last line is {"ok": true, "device": {...}}.  Without a CUDA device the
script exits nonzero before printing any result.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 0
# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of bytes over the memory rate and operations over
# the tensor-core rate of its type.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# (name, shape in its layout, layout, causal, dtype, q/k/v as the strided
# qkv[:, i] views of one [B, S, 3, N, H] projection)
KERNEL_CASES = [
    ("main bnsh causal bf16", (4, 12, 1024, 64), "bnsh", True, "bfloat16",
     False),
    ("bnsh non-causal bf16", (4, 12, 1024, 64), "bnsh", False, "bfloat16",
     False),
    ("bsnh causal bf16", (4, 1024, 12, 64), "bsnh", True, "bfloat16", False),
    ("bnsh causal f32", (4, 12, 1024, 64), "bnsh", True, "float32", False),
    ("ragged H16 S200 bf16", (2, 4, 200, 16), "bnsh", True, "bfloat16",
     False),
    ("ragged H16 S200 f32", (2, 200, 4, 16), "bsnh", False, "float32",
     False),
    ("ragged H32 S300 bf16", (2, 300, 4, 32), "bsnh", True, "bfloat16",
     False),
    ("H128 S256 bf16", (2, 4, 256, 128), "bnsh", False, "bfloat16", False),
    ("H128 S256 f32", (2, 4, 256, 128), "bnsh", True, "float32", False),
    # Ragged S on the wgmma kernels: padded queries in the dk/dv kernel, a
    # ragged key tile in dq.
    ("ragged H64 S200 bsnh causal bf16", (2, 200, 4, 64), "bsnh", True,
     "bfloat16", False),
    ("ragged H128 S320 bnsh bf16", (2, 4, 320, 128), "bnsh", False,
     "bfloat16", False),
    # The training call (bench.py's batch): q/k/v as the GPT block hands
    # them over, dO contiguous as autograd does.
    ("train call bnsh causal bf16 qkv views", (32, 12, 1024, 64), "bnsh",
     True, "bfloat16", True),
]
MAIN_CASE, TRAIN_CASE = KERNEL_CASES[0], KERNEL_CASES[-1]
# Against the plain version in f32: (o atol = o rtol, lse atol).
KERNEL_TOL = {"bfloat16": (1e-2, 1e-3), "float32": (1e-4, 1e-4)}
# Backward against the plain version in f32: max |err| <= tol x max |ref|
# per tensor (bf16: P and dS are rounded before their products, and the
# outputs to bf16; f32: sums in another order).
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# Training checks: f32 flash loss within this relative distance of dense,
# each grad leaf within GRAD_TOL x max |leaf|; per leaf, the bf16 flash
# grads' distance ||g - g32|| / ||g32|| from the f32 dense grads at most
# REL_MULT x the bf16 dense grads', and their cosine with them at most
# COS_MARGIN below the bf16 dense grads'.  GPT-2-small at [2, 1024], seed
# 0, on an H100 read a worst distance ratio of 1.077 and a worst cosine
# gap of 5.1e-6; the limits leave room above those readings.
LOSS_RTOL, GRAD_TOL, REL_MULT, COS_MARGIN = 1e-5, 1e-3, 1.25, 5e-5
# The sharded step of a one-rank mesh against the unsharded step in bf16:
# the same math but for the qkv projection, which the sharded block runs
# as three products (parallel layer), so loss and grad norm within bf16
# rounding.
DIST_RTOL = 1e-2


# Device time by kind of kernel in a profile, matched by name in order:
# the port's kernels, cuBLAS GEMMs, reductions (softmax, norms, sums),
# then element-wise and copy kernels.
KERNEL_CLASSES = (
    ("flash", ("flash_",)),
    ("gemm", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("reduce", ("reduce_kernel", "softmax", "norm")),
    ("elementwise_copy", ("elementwise", "copy", "Copy", "Functor",
                          "index")),
)


@dataclasses.dataclass(frozen=True)
class Family:
    """A model family's entry points, as the phases call them.  ``model`` is
    the engine's model name; ``prefix`` starts the family's phase names
    (GPT's phases keep their bare names)."""
    model: str
    prefix: str
    init: object
    forward: object
    loss: object
    train_state: object
    train_step: object
    decode_step: object
    init_cache: object


def family(cfg) -> Family:
    """LLaMA's entry points for a LlamaConfig, else GPT's; an MoE GPT
    (``num_experts > 0``, training only: serving keeps the dense FFN) has
    the phase prefix ``moe_``."""
    from ray_tpu_torch import models as m
    if isinstance(cfg, m.LlamaConfig):
        return Family("llama", "llama_", m.llama_init, m.llama_forward,
                      m.llama_loss, m.llama_make_train_state,
                      m.llama_make_train_step, m.llama_decode_step,
                      m.llama_init_paged_cache)
    return Family("gpt", "moe_" if cfg.num_experts else "", m.gpt_init,
                  m.gpt_forward, m.gpt_loss, m.make_train_state,
                  m.make_train_step, m.gpt_decode_step, m.init_paged_cache)


_T0 = time.monotonic()


def emit(phase: str, **fields):
    """One phase line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": round(time.monotonic() - _T0, 1)}),
          flush=True)


def check(cond, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


KERNEL_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "splash_fwd",
                "splash_bwd_dq", "splash_bwd_dkv")


def _counted():
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.ops.splash_attention import splash_attention
    return (flash_attention, splash_attention)


def launch_counts():
    """Launches so far of each kernel, in KERNEL_NAMES order: flash
    forward, dq, dkv, then splash forward, dq, dkv."""
    return tuple(getattr(fn, name) for fn in _counted()
                 for name in ("launches", "dq_launches", "dkv_launches"))


def reset_launch_counts():
    for fn in _counted():
        fn.launches = fn.dq_launches = fn.dkv_launches = 0


def case_inputs(gen, dev, shape, dtype, views, n):
    """``n`` seeded normal tensors of ``shape`` (q, k, v, then dO).  With
    ``views`` (bnsh) q, k and v are the strided qkv[:, i] views of one
    [B, S, 3, N, H] tensor, as the GPT block hands them to the kernels."""
    import torch
    dt = getattr(torch, dtype)
    out = []
    if views:
        B, N, S, H = shape
        qkv = torch.randn((B, S, 3, N, H), generator=gen, device=dev,
                          dtype=dt).permute(0, 2, 3, 1, 4)
        out = [qkv[:, 0], qkv[:, 1], qkv[:, 2]]
    return out + [torch.randn(shape, generator=gen, device=dev, dtype=dt)
                  for _ in range(n - len(out))]


def named_leaves(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from named_leaves(v, name)
        else:
            yield name, v


# ------------------------------------------------------------------ phases

# The kernels redesigned on wgmma, TMA and warp specialisation (bf16, head
# dims 64 and 128), as (source, the name each has in its library).
REDESIGNED = [("splash_attention.cu", "splash_fwd_kernel"),
              ("splash_attention.cu", "splash_dq_kernel"),
              ("splash_attention.cu", "splash_dkv_kernel"),
              ("flash_fwd.cu", "flash_fwd_kernel"),
              ("flash_bwd.cu", "flash_bwd_dq_kernel"),
              ("flash_bwd.cu", "flash_bwd_dkv_kernel")]
REDESIGNED_HEAD_DIMS = (64, 128)


def ptxas_by_kernel(lines):
    """{mangled kernel name: the ptxas lines that follow its "Compiling
    entry function" line}."""
    out, cur = {}, None
    for ln in lines:
        m = re.search(r"entry function '([^']+)'", ln)
        if m:
            cur = out.setdefault(m.group(1), [])
        elif cur is not None:
            cur.append(ln)
    return out


def sass_by_kernel(lib):
    """{mangled kernel name: its SASS} of a built library, read with
    cuobjdump -sass from the toolkit beside nvcc."""
    from ray_tpu_torch.ops import _build
    sass = subprocess.run([_build.find_tool("cuobjdump"), "-sass", lib],
                          capture_output=True, text=True, timeout=600,
                          check=True).stdout
    out = {}
    for chunk in sass.split("Function : ")[1:]:
        name, _, body = chunk.partition("\n")
        out[name.strip()] = body
    return out


def phase_build():
    """Build every source (one nvcc each, in parallel) and show, for each
    redesigned kernel, its registers, spills and ptxas warnings, whether
    setmaxnreg was ignored (C7508), and whether its SASS holds HGMMA
    (wgmma) and UTMALDG (TMA tile loads)."""
    from ray_tpu_torch.ops import _build
    t0 = time.perf_counter()
    built = _build.build_all()
    secs = time.perf_counter() - t0
    redesigned, ignored = {}, []
    for source in sorted({src for src, _ in REDESIGNED}):
        kernels = [k for src, k in REDESIGNED if src == source]
        ptxas = built[source]["ptxas"]
        ignored += [ln for ln in ptxas if "C7508" in ln]
        per_kernel = ptxas_by_kernel(ptxas)
        sass = sass_by_kernel(_build.library_path(source))
        for name, body in sorted(sass.items()):
            # the length-prefixed name, so splash_dq_kernel is not
            # splash_dq_f32_kernel and flash_bwd_dq_kernel not
            # flash_bwd_dq_mma_kernel
            if not any(f"{len(k)}{k}" in name for k in kernels):
                continue
            lines = per_kernel.get(name, [])
            regs = re.search(r"Used (\d+) registers", " ".join(lines))
            spills = next((ln for ln in lines if "spill" in ln), None)
            redesigned[name] = {
                "source": source,
                "registers": int(regs.group(1)) if regs else None,
                "spills": spills,
                "spilled": bool(spills and
                                re.search(r"[1-9]\d* bytes spill", spills)),
                "setmaxnreg_ignored": any("C7508" in ln for ln in lines),
                "warnings": [ln for ln in lines
                             if re.search(r"warning|\(C\d+\)", ln, re.I)],
                "HGMMA": "HGMMA" in body, "UTMALDG": "UTMALDG" in body}
    emit("build", seconds=secs, sources=list(built.values()),
         redesigned=redesigned, setmaxnreg_ignored_lines=ignored)
    check(len(redesigned) == len(REDESIGNED) * len(REDESIGNED_HEAD_DIMS),
          f"redesigned kernels found in the libraries: {sorted(redesigned)}")
    missing = [n for n, r in redesigned.items()
               if not (r["HGMMA"] and r["UTMALDG"])]
    check(not missing, f"no HGMMA or no UTMALDG in the SASS of {missing}")
    spilled = [n for n, r in redesigned.items() if r["spilled"]]
    check(not spilled, f"redesigned kernels that spill: {spilled}")
    check(not ignored, f"ptxas ignored setmaxnreg: {ignored}")
    return redesigned


def phase_kernel(dev, cases=KERNEL_CASES):
    """Each case: the wrapper (the kernel on a card) against the plain
    version run in f32 on the same inputs.  Returns {name: (o err, lse
    err)}."""
    import torch
    from ray_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                   flash_attention_reference)
    errs = {}
    for i, (name, shape, layout, causal, dtype, views) in enumerate(cases):
        gen = torch.Generator(device=dev).manual_seed(SEED + i)
        q, k, v = case_inputs(gen, dev, shape, dtype, views, 3)
        o, lse = flash_attention_fwd(q, k, v, causal, layout=layout)
        sync(dev)
        ro, rl = flash_attention_reference(q.float(), k.float(), v.float(),
                                           causal, layout=layout)
        tol_o, tol_lse = KERNEL_TOL[dtype]
        err_o = (o.float() - ro).abs()
        err_lse = float((lse - rl).abs().max())
        ok = bool((err_o <= tol_o + tol_o * ro.abs()).all()) and \
            err_lse <= tol_lse and bool(torch.isfinite(o).all())
        errs[name] = (float(err_o.max()), err_lse)
        emit("kernel", case=name, shape=list(shape), layout=layout,
             causal=causal, dtype=dtype, qkv_views=views,
             o_max_abs_err=errs[name][0],
             lse_max_abs_err=err_lse, o_tol=tol_o, lse_tol=tol_lse, ok=ok)
        check(ok, f"flash kernel case {name!r} outside tolerance")
    return errs


def phase_kernel_bwd(dev, cases=KERNEL_CASES):
    """Each case: dq, dk, dv from the backward kernels (o and lse from the
    forward kernel) against the plain backward run in f32 on the same
    inputs.  Returns {name: {"dq": err, "dk": err, "dv": err}}."""
    import torch
    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_reference,
        flash_attention_fwd)
    errs = {}
    for i, (name, shape, layout, causal, dtype, views) in enumerate(cases):
        gen = torch.Generator(device=dev).manual_seed(SEED + 100 + i)
        q, k, v, do = case_inputs(gen, dev, shape, dtype, views, 4)
        o, lse = flash_attention_fwd(q, k, v, causal, layout=layout)
        got = flash_attention_bwd(q, k, v, o, lse, do, causal, layout=layout)
        sync(dev)
        want = flash_attention_bwd_reference(
            q.float(), k.float(), v.float(), o.float(), lse, do.float(),
            causal, layout=layout)
        tol, fields, ok = BWD_TOL[dtype], {}, True
        errs[name] = {}
        for t, a, b in zip(("dq", "dk", "dv"), got, want):
            err, ref = float((a.float() - b).abs().max()), float(
                b.abs().max())
            errs[name][t] = err
            fields[f"{t}_max_abs_err"], fields[f"{t}_max_abs_ref"] = err, ref
            ok = ok and err <= tol * ref and bool(torch.isfinite(a).all())
        emit("kernel_bwd", case=name, shape=list(shape), layout=layout,
             causal=causal, dtype=dtype, qkv_views=views, tol_rel=tol,
             ok=ok, **fields)
        check(ok, f"flash backward case {name!r} outside tolerance")
    return errs


def phase_forward(dev, cfg, params, B, S, windows_n=5, per_window=4):
    """The model's forward (GPT or LLaMA, by ``cfg``; phase ``forward`` or
    ``llama_forward``) with the flash kernel, against the dense forward.

    f32: flash logits within 2e-3 of dense.  bf16: logits finite, and the
    flash forward's top-1 agrees with the f32 forward's at least as often
    as the dense bf16 forward's does (less half a point).  With random
    weights the top two logits of a few percent of positions lie closer
    than bf16's logit error, so neither bf16 path can match the other or
    the f32 forward everywhere; the comparison with f32 says whether flash
    is the less accurate of the two."""
    import torch
    from ray_tpu_torch.ops.flash_attention import flash_attention
    fam = family(cfg)
    gen = torch.Generator().manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen).to(dev)
    per_fwd = cfg.num_layers if dev.type == "cuda" else 0

    def forward(dtype, attention):
        n0 = flash_attention.launches
        logits = fam.forward(params, tokens, dataclasses.replace(
            cfg, dtype=dtype, attention=attention))
        sync(dev)
        n = flash_attention.launches - n0
        check(n == (per_fwd if attention == "flash" else 0),
              f"{attention} {dtype} forward launched the kernel {n} times")
        check(logits.shape == (B, S, cfg.vocab_size), "logits shape")
        check(bool(torch.isfinite(logits).all()),
              f"{attention} {dtype} logits not finite")
        return logits

    dense32 = forward(torch.float32, "dense")
    top2 = dense32.topk(2, dim=-1).values
    out = {"f32_max_abs_diff_vs_dense": float(
        (forward(torch.float32, "flash") - dense32).abs().max()),
        "f32_top2_gap_p05": float(torch.quantile(
            (top2[..., 0] - top2[..., 1]).flatten(), 0.05))}
    top = {"f32": dense32.argmax(-1)}
    for attention in ("flash", "dense"):
        logits = forward(torch.bfloat16, attention)
        out[f"bf16_{attention}_max_abs_diff_vs_f32"] = float(
            (logits - dense32).abs().max())
        top[attention] = logits.argmax(-1)
        del logits
    del dense32
    for a, b in (("flash", "dense"), ("flash", "f32"), ("dense", "f32")):
        out[f"bf16_top1_{a}_vs_{b}"] = float(
            (top[a] == top[b]).float().mean())

    # The forward is host-bound, so its wall time swings with the host's
    # load: time several windows and report their median and all of them.
    bf = dataclasses.replace(cfg, dtype=torch.bfloat16, attention="flash")
    fam.forward(params, tokens, bf)          # warm
    sync(dev)
    n0 = flash_attention.launches
    windows = []
    for _ in range(windows_n):
        t0 = time.perf_counter()
        for _ in range(per_window):
            fam.forward(params, tokens, bf)
        sync(dev)
        windows.append((time.perf_counter() - t0) / per_window * 1e3)
    ms = statistics.median(windows)
    launched = flash_attention.launches - n0
    emit(fam.prefix + "forward", batch=B, seq=S,
         launches_per_forward=per_fwd,
         bf16_ms_per_forward=ms, bf16_ms_windows=windows,
         bf16_tokens_per_s=B * S / (ms / 1e3), f32_tol=2e-3, **out)
    if dev.type == "cuda":
        profile_window(fam.prefix + "forward_profile",
                       lambda: fam.forward(params, tokens, bf), dev)
    check(launched == per_fwd * windows_n * per_window,
          "timed forwards launched the kernel a wrong number of times")
    check(out["f32_max_abs_diff_vs_dense"] <= 2e-3,
          "f32 flash logits not within 2e-3 of dense")
    check(out["bf16_top1_flash_vs_f32"] >=
          out["bf16_top1_dense_vs_f32"] - 0.005,
          "bf16 flash top-1 is further from the f32 forward than dense's")
    return {"launches_per_forward": per_fwd, "ms": ms,
            "bf16_flash_max_abs_diff_vs_f32":
            out["bf16_flash_max_abs_diff_vs_f32"],
            **{k: v for k, v in out.items() if k.startswith("bf16_top1")}}


PROFILER_SESSIONS = 3


def profiled(fn, iters, activities, want=None):
    """``fn`` run ``iters`` times under torch.profiler (CUPTI); returns the
    key averages of its CUDA kernels, each as (device us, name, events),
    and the wall ms per call.  A session whose trace came back with no CUDA
    kernel whose name holds ``want`` (no kernel at all when ``want`` is
    None) is run again, up to PROFILER_SESSIONS sessions, since the
    profiler now and then hands back a session without its device events;
    every such miss is printed as a ``profiler_miss`` line."""
    import torch
    from torch.profiler import profile
    for session in range(PROFILER_SESSIONS):
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / iters
        kernels = [(e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if any(us > 0 and (want is None or want in k)
               for us, k, _ in kernels):
            return kernels, wall
        emit("profiler_miss", want=want, session=session + 1,
             of=PROFILER_SESSIONS, kernels_seen=len(kernels))
    return kernels, wall


def kernel_breakdown(kernels, iters):
    """From ``profiled``'s (device us, name) over ``iters`` calls: (the
    kernels as (ms per call, name), largest first; their sum; the flash
    kernels' ms by name; ms by kind, ``KERNEL_CLASSES``)."""
    kernels = sorted(((us / 1e3 / iters, k) for us, k, _ in kernels),
                     reverse=True)
    flash = {name: sum(ms for ms, k in kernels if name in k)
             for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    by_class = {}
    for ms, k in kernels:
        cls = next((c for c, words in KERNEL_CLASSES
                    if any(w in k for w in words)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + ms
    return kernels, sum(ms for ms, _ in kernels), flash, by_class


def profile_window(phase, fn, dev, iters=3, top=8):
    """Where one call of ``fn`` spends its time on the card: device time
    by kernel (torch.profiler, CUPTI) against the wall clock of the same
    window, per call."""
    from torch.profiler import ProfilerActivity
    sync(dev)
    kernels, wall = profiled(fn, iters, [ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
    if not any(us > 0 for us, _, _ in kernels):
        emit(phase, wall_ms_per_call=wall, device_trace="missing")
        return
    kernels, busy, flash, by_class = kernel_breakdown(kernels, iters)
    emit(phase, wall_ms_per_call=wall, device_busy_ms_per_call=busy,
         device_idle_share=1 - busy / wall,
         flash_ms_per_call=sum(flash.values()),
         flash_share_of_busy=sum(flash.values()) / busy,
         flash_kernels_ms_per_call=flash, device_ms_by_class=by_class,
         top_kernels=[{"name": k[:80], "ms_per_call": ms}
                      for ms, k in kernels[:top]])


def _prompts(n, lo, hi, vocab):
    import numpy as np
    rng = np.random.default_rng(SEED)
    lens = rng.integers(lo, hi + 1, n)
    lens[0], lens[1] = hi, lo                 # both ends of the range
    return [rng.integers(0, vocab, int(L)).tolist() for L in lens]


def engine_kwargs(page, max_prompt, max_new, max_batch) -> dict:
    """EngineConfig's sizes for ``max_batch`` sequences of up to
    ``max_prompt`` + ``max_new`` tokens at once (page 0 is scratch)."""
    need = -(-(max_prompt + max_new) // page)
    return dict(page_size=page, num_pages=1 + max_batch * need,
                max_batch=max_batch, max_prompt_len=max_prompt,
                max_new_tokens=max_new)


def _serve_once(dev, cfg, params, prompts, page, max_prompt, max_new,
                max_batch):
    """The engine on ``prompts`` at once: per request (tokens, seconds to
    the first token, seconds to the last), the wall seconds, the stats."""
    from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine
    eng_cfg = EngineConfig(model=family(cfg).model, model_config=cfg,
                           device=dev, **engine_kwargs(
                               page, max_prompt, max_new, max_batch))

    async def run():
        eng = InferenceEngine(eng_cfg, params=params)

        async def one(p):
            t0, first, toks = time.perf_counter(), None, []
            async for t in eng.generate(p, max_new):
                if first is None:
                    first = time.perf_counter() - t0
                toks.append(t)
            return toks, first, time.perf_counter() - t0

        try:
            t0 = time.perf_counter()
            res = await asyncio.gather(*(one(p) for p in prompts))
            wall = time.perf_counter() - t0
            return res, wall, eng.stats()
        finally:
            eng.close()

    res, wall, stats = asyncio.run(run())
    check(stats["active"] == 0 and stats["waiting"] == 0,
          f"engine left work behind: {stats}")
    check(stats["free_pages"] == eng_cfg.num_pages - 1,
          f"engine did not return every page: {stats}")
    check(all(len(t) == max_new for t, _, _ in res),
          "a request was not answered in full")
    return res, wall, stats


def phase_serve(dev, cfg, params, n_req, prompt_lo, max_prompt, max_new,
                page, max_batch, n_checked, n_greedy):
    """The engine (GPT or LLaMA, by ``cfg``; phase ``serve`` or
    ``llama_serve``) in f32 (greedy held to the dense forward) and in bf16
    (throughput, time to first token)."""
    import torch
    fam = family(cfg)
    prompts = _prompts(n_req, prompt_lo, max_prompt, cfg.vocab_size)
    c32 = dataclasses.replace(cfg, dtype=torch.float32, attention="dense")
    res, wall32, _ = _serve_once(dev, c32, params, prompts, page, max_prompt,
                                 max_new, max_batch)
    ties = 0
    for p, (toks, _, _) in list(zip(prompts, res))[:n_checked]:
        # Teacher-forced along the engine's tokens: one causal forward
        # gives the dense model's prediction at every step.
        seq = torch.tensor([p + toks[:n_greedy - 1]], device=dev)
        logits = fam.forward(params, seq, c32)[0, len(p) - 1:]
        for t in range(n_greedy):
            want = int(logits[t].argmax())
            if want == toks[t]:
                continue
            top2 = logits[t].topk(2).values
            tie = float(top2[0] - top2[1]) < 1e-4 and \
                float(top2[0] - logits[t][toks[t]]) < 1e-4
            check(tie, f"f32 engine token {toks[t]} != dense greedy {want} "
                       f"at step {t} of a {len(p)}-token prompt")
            ties += 1
    cbf = dataclasses.replace(cfg, dtype=torch.bfloat16, attention="dense")
    res, wall, stats = _serve_once(dev, cbf, params, prompts, page,
                                   max_prompt, max_new, max_batch)
    if dev.type == "cuda":
        profile_decode_step(dev, cbf, params, prompts, page, max_prompt,
                            max_new, max_batch)
    gen_tokens = sum(len(t) for t, _, _ in res)
    fields = dict(
        requests=n_req, slots=max_batch, page_size=page,
        prompt_lens=[len(p) for p in prompts], max_new_tokens=max_new,
        f32_greedy_checked=n_checked, f32_greedy_steps=n_greedy,
        f32_accepted_near_ties=ties, f32_tokens_per_s=n_req * max_new /
        wall32, bf16_generated_tokens=gen_tokens,
        bf16_tokens_per_s=gen_tokens / wall,
        bf16_p50_ttft_ms=statistics.median(f for _, f, _ in res) * 1e3,
        bf16_decode_steps=stats["steps"], free_pages=stats["free_pages"])
    emit(fam.prefix + "serve", **fields)
    return fields


def profile_decode_step(dev, cfg, params, prompts, page, max_prompt,
                        max_new, max_batch):
    """One batched decode step at the serve phase's shape: every slot
    busy, each sequence at the end of its prompt."""
    import torch
    fam = family(cfg)
    need = -(-(max_prompt + max_new) // page)
    kp, vp = fam.init_cache(cfg, 1 + max_batch * need, page, device=dev)
    tables = torch.arange(1, 1 + max_batch * need,
                          device=dev).reshape(max_batch, need)
    pos = torch.tensor([len(p) for p in prompts[:max_batch]], device=dev)
    token = torch.zeros(max_batch, dtype=torch.long, device=dev)
    profile_window(fam.prefix + "decode_profile", lambda: fam.decode_step(
        params, cfg, token, pos, kp, vp, tables), dev)


def _loss_and_grads(params, tokens, cfg):
    """Loss and grads of one backward of the family's loss (no optimizer
    step); the params' .grad are cleared again."""
    leaves = [p for _, p in named_leaves(params)]
    for p in leaves:
        p.grad = None
    loss = family(cfg).loss(params, {"tokens": tokens}, cfg)
    loss.backward()
    grads = [p.grad for p in leaves]
    for p in leaves:
        p.grad = None
    return float(loss.detach()), grads


def _cosine(a, b):
    import torch
    a, b = a.flatten().double(), b.flatten().double()
    return float(torch.dot(a, b) / (a.norm() * b.norm()))


def _grad_errs(got, want):
    """Per leaf, max |got - want| over max |want|."""
    return [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(got, want)]


def _rel_dist(a, b):
    """||a - b|| / ||b||: unlike the cosine, it sees a wrong scale."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def moe_flops(cfg, S, n_params):
    """MFLOP per token of an MoE GPT training step, counted two ways, with
    the formulas: the model's (bench.py's 6 N + 12 L S D over the params a
    token uses: every non-expert param and top_k experts a layer) and the
    executed (every capacity slot of every expert, the padding included,
    plus the dispatch and combine einsums, 2 E C D each per token and
    pass, three passes)."""
    from ray_tpu_torch.ops.moe import moe_capacity
    E, k, L, D, M = (cfg.num_experts, cfg.expert_top_k, cfg.num_layers,
                     cfg.embed_dim, cfg.mlp_dim)
    C = moe_capacity(S, k, E, cfg.capacity_factor)
    per_expert = 2 * D * M + M + D
    n_active = n_params - L * (E - k) * per_expert
    n_shared = n_params - L * E * per_expert
    attn = 12 * L * S * D
    model = 6 * n_active + attn
    executed = (6 * (n_shared + L * per_expert * E * C / S) + attn
                + 12 * L * E * C * D)
    return {"capacity": C, "n_active": n_active, "per_expert": per_expert,
            "model_mflop_per_token": model / 1e6,
            "executed_mflop_per_token": executed / 1e6,
            "model_formula": "6*(N - L*(E-k)*P) + 12*L*S*D, P = 2*D*M+M+D",
            "executed_formula": "6*(N - L*E*P + L*P*E*C/S) + 12*L*S*D "
                                "+ 12*L*E*C*D"}


def moe_routing_stats(params, tokens, cfg):
    """(the load-balance loss per layer, the share of routed (token,
    choice) pairs dropped over capacity, that share layer by layer) of one
    no-grad forward of ``tokens``.  The drops are counted by wrapping the router's per-rank
    routing (``ops.moe._route``) for this forward only."""
    import torch
    from ray_tpu_torch.models.gpt import gpt_hidden
    from ray_tpu_torch.ops import moe as moe_ops

    route, kept, routed = moe_ops._route, [], []

    def counting(probs, top_k, capacity, dtype):
        out = route(probs, top_k, capacity, dtype)
        kept.append(out[0].float().sum())
        routed.append(probs.shape[0] * probs.shape[1] * top_k)
        return out

    moe_ops._route = counting
    try:
        with torch.no_grad():
            _, aux = gpt_hidden(params, tokens, cfg)
    finally:
        moe_ops._route = route
    kept = [float(k) for k in kept]
    return (float(aux) / cfg.num_layers, 1.0 - sum(kept) / sum(routed),
            [1.0 - k / r for k, r in zip(kept, routed)])


def phase_train(dev, cfg, B, S, check_B=2, warm=1, steps=8):
    """Training at full width (GPT or LLaMA, by ``cfg``; phases
    ``train_check``, ``train``, ``train_profile``, with ``llama_`` before
    LLaMA's); see the module docstring.  ``cfg`` is the training
    configuration itself: bf16 compute, flash attention, remat "dots"
    (what the launch counts expect), its ``ce_block``.  On the CPU (a
    rehearsal at a tiny config) no kernel launches."""
    import torch
    fam = family(cfg)
    check(cfg.dtype == torch.bfloat16 and cfg.attention == "flash" and
          cfg.remat and cfg.remat_policy == "dots",
          f"phase_train takes a bf16 flash config under remat dots: {cfg}")
    params, opt = fam.train_state(SEED, cfg, learning_rate=3e-4,
                                  weight_decay=1e-4, device=dev)
    names = [n for n, _ in named_leaves(params)]
    # bench.py's model FLOPs per token: 6 N + 12 L S D (N the params a
    # token uses, for an MoE GPT)
    n_params = sum(p.numel() for _, p in named_leaves(params))
    moe = moe_flops(cfg, S, n_params) if fam.prefix == "moe_" else None
    mflop_per_token = (moe["model_mflop_per_token"] if moe else
                       (6 * n_params + 12 * cfg.num_layers * S *
                        cfg.embed_dim) / 1e6)
    gen = torch.Generator().manual_seed(SEED + 1)
    check_tokens = torch.randint(0, cfg.vocab_size, (check_B, S + 1),
                                 generator=gen).to(dev)
    L = cfg.num_layers if dev.type == "cuda" else 0

    # (a) f32: flash against dense, loss and every grad leaf.
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    loss_f, g_flash = _loss_and_grads(params, check_tokens, c32)
    loss_d, g_dense32 = _loss_and_grads(
        params, check_tokens, dataclasses.replace(c32, attention="dense"))
    ratios = _grad_errs(g_flash, g_dense32)
    del g_flash
    worst = max(range(len(ratios)), key=ratios.__getitem__)
    loss_rel = abs(loss_f - loss_d) / abs(loss_d)
    # (b) bf16: flash grads no further from f32 dense than dense bf16's.
    _, g_fb = _loss_and_grads(params, check_tokens, cfg)
    cos_flash = [_cosine(a, b) for a, b in zip(g_fb, g_dense32)]
    rel_flash = [_rel_dist(a, b) for a, b in zip(g_fb, g_dense32)]
    del g_fb
    _, g_db = _loss_and_grads(params, check_tokens,
                              dataclasses.replace(cfg, attention="dense"))
    cos_dense = [_cosine(a, b) for a, b in zip(g_db, g_dense32)]
    rel_dense = [_rel_dist(a, b) for a, b in zip(g_db, g_dense32)]
    del g_db, g_dense32
    gaps = [d - f for f, d in zip(cos_flash, cos_dense)]
    rel_ratios = [f / d for f, d in zip(rel_flash, rel_dense)]
    worst_rel = max(range(len(rel_ratios)), key=rel_ratios.__getitem__)
    emit(fam.prefix + "train_check", batch=check_B, seq=S,
         f32_loss_flash=loss_f,
         f32_loss_dense=loss_d, f32_loss_rel_diff=loss_rel,
         loss_rtol=LOSS_RTOL, f32_grad_worst_leaf=names[worst],
         f32_grad_worst_err_over_max=ratios[worst], grad_tol=GRAD_TOL,
         bf16_min_cos_flash=min(cos_flash), bf16_min_cos_dense=min(cos_dense),
         bf16_worst_cos_gap=max(gaps),
         bf16_worst_cos_gap_leaf=names[max(range(len(gaps)),
                                           key=gaps.__getitem__)],
         cos_margin=None if moe else COS_MARGIN,
         bf16_max_rel_dist_flash=max(rel_flash),
         bf16_max_rel_dist_dense=max(rel_dense),
         bf16_worst_rel_dist_ratio=rel_ratios[worst_rel],
         bf16_worst_rel_dist_ratio_leaf=names[worst_rel],
         bf16_worst_rel_dist_ratio_leaf_flash_dense=[rel_flash[worst_rel],
                                                     rel_dense[worst_rel]],
         rel_mult=REL_MULT)
    check(loss_rel <= LOSS_RTOL, "f32 flash loss not within 1e-5 of dense")
    check(max(ratios) <= GRAD_TOL,
          f"f32 flash grad of {names[worst]} too far from dense")
    # The cosine margin is absolute, set on dense models whose bf16 grads
    # keep cosines near 0.9999 with f32's.  An MoE's bf16 forward routes
    # some tokens to other experts than its f32 forward (top-2 of gates
    # closer than bf16 rounding), in both paths alike, which takes both
    # cosines to about 0.95 (MoE GPT-2-small at [2, 1024], seed 0, on an
    # H100): there the scale-free relative-distance limit below is the
    # check.
    if not moe:
        check(max(gaps) <= COS_MARGIN,
              "bf16 flash grads' cosine further from f32 than bf16 dense's")
    check(all(f <= REL_MULT * d for f, d in zip(rel_flash, rel_dense)),
          f"bf16 flash grad of {names[worst_rel]} further from f32 than "
          f"{REL_MULT} x the bf16 dense grad's distance")

    # (d) launches of one backward under the other remat policies
    policies = {}
    for policy, fwd in (("full", 2 * L), ("attn", L), ("attn_dots", L)):
        n0 = launch_counts()
        loss, _ = _loss_and_grads(params, check_tokens, dataclasses.replace(
            cfg, remat_policy=policy))
        sync(dev)
        n = [b - a for a, b in zip(n0, launch_counts())]
        policies[policy] = n
        want = [fwd, L, L, 0, 0, 0]
        check(n == want and math.isfinite(loss),
              f"remat {policy}: launches {n}, expected {want}")

    # (c) bench.py's configuration: the training cfg path
    step = fam.train_step(cfg, opt)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1),
                           generator=gen).to(dev)
    batch = {"tokens": tokens}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()                     # the training path starts
    metrics = [step(params, batch) for _ in range(warm)]
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics.append(step(params, batch))
    sync(dev)
    secs = time.perf_counter() - t0
    launches = launch_counts()                # ... and ends here
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    ms = secs / steps * 1e3
    tok_s = B * S * steps / secs
    per_step = [2 * L, L, L, 0, 0, 0]
    extra = {}
    if moe:
        aux, dropped, by_layer = moe_routing_stats(params,
                                                   check_tokens[:, :-1], cfg)
        extra = dict(moe, experts=cfg.num_experts, top_k=cfg.expert_top_k,
                     capacity_factor=cfg.capacity_factor,
                     mfu_executed=tok_s * moe["executed_mflop_per_token"]
                     * 1e6 / 989e12, aux_loss_per_layer=aux,
                     dropped_share=dropped, dropped_share_by_layer=by_layer,
                     routing_batch=[check_B, S],
                     card=nvidia_smi_line())
    emit(fam.prefix + "train", batch=B, seq=S, dtype="bfloat16",
         remat_policy="dots", ce_block=cfg.ce_block, warm_steps=warm,
         timed_steps=steps, ms_per_step=ms, samples_per_s=B * steps / secs,
         tokens_per_s=tok_s, mfu=tok_s * mflop_per_token * 1e6 / 989e12,
         n_params=n_params, mflop_per_token=mflop_per_token, losses=losses,
         grad_norms=norms,
         launches=dict(zip(KERNEL_NAMES, launches)),
         launches_per_step=per_step, other_policies_launches=policies,
         peak_memory_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                         if dev.type == "cuda" else None), **extra)
    check(all(math.isfinite(x) for x in losses + norms),
          "training loss or grad norm not finite")
    check(losses[-1] < losses[0], f"training loss did not fall: {losses}")
    check(list(launches) == [n * (warm + steps) for n in per_step],
          f"training launches {launches}, expected {per_step} per step")
    if dev.type == "cuda":
        profile_window(fam.prefix + "train_profile",
                       lambda: step(params, batch), dev, iters=1)
    return {"launches": launches, "per_step": per_step, "ms": ms}


def time_ms(fn, iters):
    """Warm, then CUDA events around ``iters`` calls: ms per call."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# (tensors of [B, N, S, H], f32 [B*N, S] statistics, products) each
# function must move or do: fwd q k v o, lse, q.k^T and p.v; dq q k v dO
# dQ, lse and D, q.k^T, dO.v^T and dS.k; dkv q k v dO dK dV, lse and D,
# q.k^T, dO.v^T, P^T.dO and dS^T.q.
FLASH_WORK = {"fwd": (4, 1, 2), "dq": (5, 2, 3), "dkv": (6, 2, 4)}


def device_ms(fn, kernel, iters):
    """Warm, then the device time per call of the kernels whose name holds
    ``kernel`` (every kernel the call launches when ``kernel`` is None),
    from torch.profiler (CUPTI) over ``iters`` calls: the kernels' own time
    even where the host cannot enqueue calls as fast as the card runs
    them.  A named kernel's events are counted (every caller's ``fn``
    launches it once): a trace that holds fewer than ``iters`` lost some,
    and its sum over ``iters`` would read short."""
    import torch
    from torch.profiler import ProfilerActivity
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    kernels, _ = profiled(fn, iters, [ProfilerActivity.CUDA], kernel)
    hits = [(us, n) for us, k, n in kernels if kernel is None or kernel in k]
    us, events = sum(us for us, _ in hits), sum(n for _, n in hits)
    if us > 0 and (kernel is None or events == iters):
        return us / 1e3 / iters
    # No session traced the kernel, or not every launch of it: its time
    # between CUDA events instead, which holds the host's gaps between
    # calls too, and says so.
    ms = time_ms(fn, iters)
    emit("profiler_miss", want=kernel, timed_by="cuda_events", ms=ms,
         events=events, expected_events=iters,
         profiler_ms=us / 1e3 / iters,
         kernels_seen=sorted({k[:60] for _, k, _ in kernels}))
    return ms


# A kernel time under its bound is a miscount (of the time or of the
# bound), not a fast kernel; 5% covers clocks above the peak rate's.
MAX_BOUND_SHARE = 1.05


def check_bound_share(name, shape, bound_ms, ms):
    check(bound_ms / ms <= MAX_BOUND_SHARE,
          f"{name} at {shape} read {ms * 1e3:.2f} us against its "
          f"{bound_ms * 1e3:.2f} us bound: the card cannot beat its bound")


def flash_bound_ms(B, N, S, H, dtype, causal, kind="fwd"):
    """Least time for one flash function: each input and output moved
    once, over the memory rate; the products these inputs need (causal:
    key j <= row i only) over the tensor-core rate of the dtype."""
    tensors, stats, products = FLASH_WORK[kind]
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = tensors * B * N * S * H * elem + stats * B * N * S * 4
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = products * 2 * H * pairs * B * N
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernel_times(dev, B, N, S, H):
    """A main-path call of the forward kernel (bf16, causal, strided bnsh
    views of one fused qkv projection) timed three ways.  ``ms`` is the
    kernel's device time; ``event_ms`` the wrapper's time per call between
    CUDA events, which the host's dispatch bounds when it is slower than
    the kernel.  The library yardstick, scaled_dot_product_attention's
    forward on the same views, likewise: ``library_ms`` the device time of
    every kernel it launches, ``library_event_ms`` between events."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                   flash_attention_reference)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = case_inputs(gen, dev, (B, N, S, H), "bfloat16", True, 3)

    def call():
        return flash_attention_fwd(q, k, v, True, layout="bnsh")

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    # "flash_fwd_" names both the wgmma kernel (flash_fwd_kernel) and the
    # mma.sync one (flash_fwd_mma_kernel), whichever this call launches
    kernel = device_ms(call, "flash_fwd_", 50)
    bound, bound_by = flash_bound_ms(B, N, S, H, "bfloat16", True)
    check_bound_share("flash_fwd", [B, N, S, H], bound, kernel)
    flop = FLASH_WORK["fwd"][2] * 2 * H * S * (S + 1) // 2 * B * N
    return {"shape": [B, N, S, H], "ms": kernel,
            "event_ms": time_ms(call, 50),
            "plain_ms": time_ms(lambda: flash_attention_reference(
                q, k, v, True, layout="bnsh"), 3),
            "library_ms": device_ms(sdpa, None, 50),
            "library_event_ms": time_ms(sdpa, 50),
            "bound_ms": bound, "bound_by": bound_by,
            "tflops": flop / 1e12 / (kernel / 1e3),
            "bound_share": bound / kernel}


def phase_kernel_bwd_times(dev, B, N, S, H):
    """The training call of each backward kernel (bf16, causal, q/k/v
    strided bnsh views of one fused qkv projection, dO contiguous, as
    autograd hands it over) timed three ways, with its achieved TFLOP/s
    and the share of its bound it reaches.  The library yardstick is
    scaled_dot_product_attention's backward (dq, dk and dv together),
    timed as forward+backward less forward on the same views: by device
    time (``library_ms``, from the profiler) and between CUDA events
    (``library_event_ms``)."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops.flash_attention import (
        _delta, _launch_dkv, _launch_dq, flash_attention_dkv_reference,
        flash_attention_dq_reference, flash_attention_fwd)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v, do = case_inputs(gen, dev, (B, N, S, H), "bfloat16", True, 4)
    o, lse = flash_attention_fwd(q, k, v, True, layout="bnsh")
    delta = _delta(o, do, "bnsh")
    scale = 1.0 / math.sqrt(H)
    args = (q, k, v, do, lse, delta, True, scale, "bnsh")
    ref_args = (q, k, v, o, lse, do, True)
    out = {}
    for kind, launch, plain in (
            ("dq", _launch_dq, flash_attention_dq_reference),
            ("dkv", _launch_dkv, flash_attention_dkv_reference)):
        out[kind] = {
            "ms": device_ms(lambda: launch(*args), f"flash_bwd_{kind}_", 20),
            "event_ms": time_ms(lambda: launch(*args), 20),
            "plain_ms": time_ms(lambda: plain(*ref_args, layout="bnsh"), 3)}
    ql, kl, vl = (x.detach().requires_grad_(True) for x in (q, k, v))

    def sdpa_fwd_bwd():
        for x in (ql, kl, vl):
            x.grad = None
        F.scaled_dot_product_attention(ql, kl, vl,
                                       is_causal=True).backward(do)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)

    fwd_bwd, fwd = time_ms(sdpa_fwd_bwd, 20), time_ms(sdpa_fwd, 20)
    fwd_bwd_dev = device_ms(sdpa_fwd_bwd, None, 20)
    fwd_dev = device_ms(sdpa_fwd, None, 20)
    for kind in ("dq", "dkv"):
        bound, bound_by = flash_bound_ms(B, N, S, H, "bfloat16", True, kind)
        flop = FLASH_WORK[kind][2] * 2 * H * S * (S + 1) // 2 * B * N
        ms = out[kind]["ms"]
        check_bound_share(f"flash_bwd_{kind}", [B, N, S, H], bound, ms)
        out[kind].update(library_ms=fwd_bwd_dev - fwd_dev,
                         library_event_ms=fwd_bwd - fwd, bound_ms=bound,
                         bound_by=bound_by,
                         tflops=flop / 1e12 / (ms / 1e3),
                         bound_share=bound / ms)
    emit("kernel_bwd_times", shape=[B, N, S, H], dtype="bfloat16",
         causal=True, library="scaled_dot_product_attention backward "
         "(dq+dk+dv) = fwd+bwd - fwd", library_fwd_bwd_ms=fwd_bwd_dev,
         library_fwd_ms=fwd_dev, library_fwd_bwd_event_ms=fwd_bwd,
         library_fwd_event_ms=fwd, **out)
    return out


# ------------------------------------------------------- splash and autotune

# The autotune path's two full-width shapes ([B, N, S, H], bf16, causal):
# (a) GPT-2-small's training attention (bench.py's configuration), where
# splash does not apply (head dim 64); (b) Llama 2 7B's attention, 32 heads
# of 128 over a 4096 context (Touvron et al. 2023, Table 1), batch 2 as the
# repo's long-context bench takes it at S=4096: the shape that reaches
# splash.
GPT2_ATTN = (32, 12, 1024, 64)
SPLASH_SHAPE = (2, 32, 4096, 128)
# (name, [B, N, S, H], dtype, fwd blocks, bwd blocks, per-head offsets)
SPLASH_CASES = [
    ("llama2-7b attention", SPLASH_SHAPE, "bfloat16", (128, 128),
     (128, 128), ()),
    ("map [[1,0],[2,1]] bf16", (1, 2, 256, 128), "bfloat16", (128, 128),
     (128, 128), ()),
    ("map [[1,0],[2,1]] f32", (1, 2, 256, 128), "float32", (128, 128),
     (128, 128), ()),
    ("H64 bf16", (1, 2, 256, 64), "bfloat16", (128, 128), (128, 128), ()),
    ("per-head offsets, unequal blocks f32", (2, 2, 512, 64), "float32",
     (256, 128), (128, 256), (0, 128)),
    ("per-head offsets, unequal blocks bf16 H128", (2, 2, 512, 128),
     "bfloat16", (256, 128), (128, 256), (0, 128)),
] + [(f"blocks fwd {f} bwd {b}", (2, 4, 1024, 128), "bfloat16", (f, f),
      (b, b), ()) for f in (128, 256, 512) for b in (128, 256, 512)]
SPLASH_MAIN = SPLASH_CASES[0]
# The design of each bf16 kernel on its main path: "wgmma+tma"
# (warp-specialised, TMA ring, wgmma from shared memory) or "mma.sync" (the
# first design).
SPLASH_BF16_DESIGN = {"fwd": "wgmma+tma", "dq": "wgmma+tma",
                      "dkv": "wgmma+tma"}
FLASH_BF16_DESIGN = {"fwd": "wgmma+tma", "dq": "wgmma+tma",
                     "dkv": "wgmma+tma"}


def splash_case_inputs(gen, dev, shape, dtype, n):
    """``n`` seeded normal tensors (q, k, v, then dO), q pre-scaled by
    1/sqrt(H) as the splash caller does."""
    import torch
    dt = getattr(torch, dtype)
    xs = [torch.randn(shape, generator=gen, device=dev, dtype=dt)
          for _ in range(n)]
    xs[0] = (xs[0] * shape[-1] ** -0.5).to(dt)
    return xs


def phase_kernel_splash(dev, cases=SPLASH_CASES):
    """Each case: the three splash kernels (forward; dq; dk and dv, from
    the forward kernel's o and lse) against their plain versions run in f32
    on the same inputs and block maps.  Returns {name: {"o", "lse", "dq",
    "dk", "dv": max |err|}}."""
    import torch
    from ray_tpu_torch.ops import splash_attention as sp
    errs = {}
    for i, (name, shape, dtype, fwd, bwd, offsets) in enumerate(cases):
        gen = torch.Generator(device=dev).manual_seed(SEED + 200 + i)
        q, k, v, do = splash_case_inputs(gen, dev, shape, dtype, 4)
        mask = sp.causal_mha_mask(shape[1], shape[2], offsets)
        fi, bi = sp.process_mask(mask, fwd), sp.process_mask(mask, bwd)
        o, lse = sp.splash_attention_fwd(q, k, v, fi)
        got = sp.splash_attention_bwd(q, k, v, o, lse, do, bi)
        sync(dev)
        f32 = [x.float() for x in (q, k, v)]
        ro, rl = sp.splash_attention_reference(*f32, fi)
        want = (sp.splash_dq_reference(*f32, o.float(), lse, do.float(), bi),
                *sp.splash_dkv_reference(*f32, o.float(), lse, do.float(),
                                         bi))
        tol_o, tol_lse = KERNEL_TOL[dtype]
        err_o = (o.float() - ro).abs()
        errs[name] = {"o": float(err_o.max()),
                      "lse": float((lse - rl).abs().max())}
        ok = bool((err_o <= tol_o + tol_o * ro.abs()).all()) and \
            errs[name]["lse"] <= tol_lse and bool(torch.isfinite(o).all())
        fields = {}
        for t, a, b in zip(("dq", "dk", "dv"), got, want):
            err, ref = float((a.float() - b).abs().max()), float(
                b.abs().max())
            errs[name][t] = err
            fields[f"{t}_max_abs_err"], fields[f"{t}_max_abs_ref"] = err, ref
            ok = ok and err <= BWD_TOL[dtype] * ref and \
                bool(torch.isfinite(a).all())
        emit("kernel_splash", case=name, shape=list(shape), dtype=dtype,
             fwd_blocks=list(fwd), bwd_blocks=list(bwd),
             offsets=list(offsets), block_map=fi.block_mask.tolist()
             if fi.block_mask.size <= 16 else None,
             o_max_abs_err=errs[name]["o"], lse_max_abs_err=errs[name]["lse"],
             o_tol=tol_o, lse_tol=tol_lse, bwd_tol_rel=BWD_TOL[dtype], ok=ok,
             **fields)
        check(ok, f"splash kernel case {name!r} outside tolerance")
        del q, k, v, do, o, lse, got, f32, ro, rl, want
    return errs


def phase_autotune(dev, cfg, shapes=(GPT2_ATTN, SPLASH_SHAPE)):
    """The autotune path at full width under a fresh cache: tune_attention
    at shapes (a) and (b) (per-variant timings, winners), a fresh
    AutotuneCache over the file reads every record back, then
    dispatch.attention(q, k, v) with no variant runs each recorded winner,
    as the launch counters show, and the model's attention="auto" takes
    the record at (a)."""
    import torch
    from ray_tpu_torch.autotune import (AutotuneCache, attention_key,
                                        backend_fingerprint, cache_path)
    from ray_tpu_torch.autotune import dispatch
    from ray_tpu_torch.models.gpt import _auto_attention_variant
    from ray_tpu_torch.ops.flash_attention import _dense_reference
    backend = backend_fingerprint(dev)
    on_card = dev.type == "cuda"
    want_variants = {shape: {"flash", "dense"} | (
        {"splash"} if shape[3] % 128 == 0 else set()) for shape in shapes}
    ops = {"splash": "splash_attention", "flash": "flash_attention",
           "dense": "dense_attention"}
    out = {}
    for B, N, S, H in want_variants:
        t0 = time.perf_counter()
        rec = dispatch.tune_attention(B, S, N, H, "bfloat16", True,
                                      device=dev)
        secs = time.perf_counter() - t0
        timings = rec["meta"]["timings"]
        key = attention_key(B, S, N, H, "bfloat16", True)
        fresh = AutotuneCache(cache_path())       # the file, read anew
        records = {v: fresh.lookup(ops[v], key, backend=backend,
                                   count=False) for v in timings}
        winner = fresh.lookup(dispatch.VARIANT_OP, key, backend=backend,
                              count=False)
        emit("autotune_sweep", shape=[B, N, S, H], dtype="bfloat16",
             backend=backend, seconds=secs, winner=rec["config"]["variant"],
             timings_ms=timings,
             records={v: {"config": r["config"], "ms": r["ms"],
                          "meta": r.get("meta")} for v, r in records.items()})
        check(set(timings) == want_variants[(B, N, S, H)],
              f"variants timed at {[B, N, S, H]}: {sorted(timings)}")
        check(all(ms is not None and math.isfinite(ms)
                  for ms in timings.values()), f"a variant did not run: "
              f"{timings}")
        check(winner is not None and winner["config"] == rec["config"] and
              all(r is not None for r in records.values()),
              "the records were not read back from the file")
        if "splash" in timings:
            check(records["splash"]["meta"]["swept"] == (9 if on_card
                                                         else 1),
                  "the splash sweep did not time all its candidates")
        out[(B, N, S, H)] = rec["config"]["variant"]

    dispatch.clear_memo()
    for i, ((B, N, S, H), winner) in enumerate(out.items()):
        gen = torch.Generator(device=dev).manual_seed(SEED + 300 + i)
        q, k, v = (torch.randn((B, S, N, H), generator=gen, device=dev,
                               dtype=torch.bfloat16) for _ in range(3))
        n0 = launch_counts()
        o = dispatch.attention(q, k, v)
        sync(dev)
        n = [b - a for a, b in zip(n0, launch_counts())]
        ran = ("flash" if n == [1, 0, 0, 0, 0, 0] else
               "splash" if n == [0, 0, 0, 1, 0, 0] else
               "dense" if not any(n) else f"launches {n}")
        ref = _dense_reference(q.float(), k.float(), v.float(), True, None)
        tol = KERNEL_TOL["bfloat16"][0]
        err = (o.float() - ref).abs()
        emit("autotune_dispatch", shape=[B, N, S, H], winner=winner,
             ran=ran, launches=dict(zip(KERNEL_NAMES, n)),
             max_abs_err_vs_dense_f32=float(err.max()), tol=tol)
        check(ran == winner or not on_card, f"dispatch at {[B, N, S, H]} "
              f"ran {ran}, the record says {winner}")
        check(bool((err <= tol + tol * ref.abs()).all()),
              f"dispatched {winner} at {[B, N, S, H]} is off dense f32")
        del q, k, v, o, ref, err
    B, N, S, H = shapes[0]
    model_auto = _auto_attention_variant(
        B, S, dataclasses.replace(cfg, dtype=torch.bfloat16), dev)
    emit("autotune_model_auto", shape=[B, N, S, H], variant=model_auto,
         record=out[shapes[0]])
    check(model_auto == out[shapes[0]],
          "the model's attention='auto' did not take the record")
    return out


def phase_splash_grad_check(dev, shape=SPLASH_SHAPE):
    """bf16 grads of attention(variant="splash") at shape (b): per tensor,
    the relative distance ||g - g32|| / ||g32|| from the f32 dense grads at
    most REL_MULT x the bf16 dense grads' (as train_check holds flash)."""
    import torch
    from ray_tpu_torch.autotune import dispatch
    B, N, S, H = shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 400)
    q, k, v, do = (torch.randn((B, N, S, H), generator=gen, device=dev,
                               dtype=torch.bfloat16) for _ in range(4))

    def grads(variant, dtype):
        leaves = [x.to(dtype, copy=True).requires_grad_(True)
                  for x in (q, k, v)]
        o = dispatch.attention(*leaves, variant=variant, layout="bnsh")
        o.backward(do.to(dtype))
        out = [x.grad.float() for x in leaves]
        del o, leaves
        torch.cuda.empty_cache()
        return out

    g32 = grads("dense", torch.float32)
    rel = {}
    for variant in ("splash", "dense"):
        rel[variant] = [_rel_dist(g, r) for g, r in zip(
            grads(variant, torch.bfloat16), g32)]
    ratios = [s / d for s, d in zip(rel["splash"], rel["dense"])]
    emit("splash_grad_check", shape=[B, N, S, H], layout="bnsh",
         bf16_rel_dist_splash=dict(zip(("dq", "dk", "dv"), rel["splash"])),
         bf16_rel_dist_dense=dict(zip(("dq", "dk", "dv"), rel["dense"])),
         ratios=dict(zip(("dq", "dk", "dv"), ratios)), rel_mult=REL_MULT)
    check(max(ratios) <= REL_MULT, f"bf16 splash grads further from f32 "
          f"than {REL_MULT} x the bf16 dense grads': {ratios}")


def splash_bound_ms(kind, B, N, S, H, pairs):
    """Least time for one splash function at bf16: each input and output
    moved once, over the memory rate; the products over the pairs
    (query, key) the mask leaves visible, over the tensor-core rate."""
    tensors, stats, products = FLASH_WORK[kind]
    nbytes = tensors * B * N * S * H * 2 + stats * B * N * S * 4
    flops = products * 2 * H * pairs * B
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS["bfloat16"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_splash_kernel_times(dev):
    """Each splash kernel at shape (b) (bf16, the causal map at 128-blocks,
    the default config) timed as the flash kernels are: device time from
    the profiler, CUDA-event time of the wrapper, the plain version's
    time; the library yardstick is scaled_dot_product_attention
    (is_causal, scale 1: q is pre-scaled), forward for the forward kernel
    and fwd+bwd less fwd for the pair."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import splash_attention as sp
    B, N, S, H = SPLASH_SHAPE
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v, do = splash_case_inputs(gen, dev, SPLASH_SHAPE, "bfloat16", 4)
    info = sp.process_mask(sp.causal_mha_mask(N, S), (128, 128))
    offsets, rows, cols = info.tensors(dev)
    blocks = (info.block_q, info.block_kv)
    o, lse = sp._launch_fwd(q, k, v, offsets, rows, *blocks)
    di = sp._di(o, do)
    # the (query, key) pairs the mask leaves visible, over all heads
    pairs = sum(int(m[0:S, 0:S].sum())
                for m in sp.causal_mha_mask(N, S).masks)
    tflop = {kind: FLASH_WORK[kind][2] * 2 * H * pairs * B / 1e12
             for kind in FLASH_WORK}
    calls = {
        "fwd": (lambda: sp._launch_fwd(q, k, v, offsets, rows, *blocks),
                "splash_fwd_kernel",
                lambda: sp.splash_attention_reference(q, k, v, info)),
        "dq": (lambda: sp._launch_dq(q, k, v, do, lse, di, offsets, rows,
                                     *blocks), "splash_dq_kernel",
               lambda: sp.splash_dq_reference(q, k, v, o, lse, do, info)),
        "dkv": (lambda: sp._launch_dkv(q, k, v, do, lse, di, offsets, cols,
                                       *blocks), "splash_dkv_kernel",
                lambda: sp.splash_dkv_reference(q, k, v, o, lse, do, info)),
    }
    out = {}
    for kind, (fn, kernel, plain) in calls.items():
        bound, bound_by = splash_bound_ms(kind, B, N, S, H, pairs)
        ms = device_ms(fn, kernel, 20)
        check_bound_share(kernel, list(SPLASH_SHAPE), bound, ms)
        out[kind] = {"ms": ms, "event_ms": time_ms(fn, 20),
                     "plain_ms": time_ms(plain, 2),
                     "bound_ms": bound, "bound_by": bound_by,
                     "tflops": tflop[kind] / (ms / 1e3),
                     "bound_share": bound / ms,
                     "design": SPLASH_BF16_DESIGN[kind]}
    ql, kl, vl = (x.detach().requires_grad_(True) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                              scale=1.0)

    def sdpa_fwd_bwd():
        for x in (ql, kl, vl):
            x.grad = None
        sdpa().backward(do)

    fwd_bwd, fwd = time_ms(sdpa_fwd_bwd, 20), time_ms(sdpa, 20)
    out["fwd"]["library_ms"] = fwd
    for kind in ("dq", "dkv"):
        out[kind]["library_ms"] = fwd_bwd - fwd
    emit("splash_kernel_times", shape=list(SPLASH_SHAPE), dtype="bfloat16",
         blocks=list(blocks), visible_pairs=pairs,
         library="scaled_dot_product_attention (is_causal, scale 1); "
         "backward = fwd+bwd - fwd (dq+dk+dv)", library_fwd_bwd_ms=fwd_bwd,
         library_fwd_ms=fwd, **out)
    return out


# Where the bf16 forward kernels stand against SDPA's forward beyond the
# main paths' shapes: GPT-2-small's inference and training calls, a long
# sequence at its head dim, and shape (b).
ATTENTION_SHAPES = [(4, 12, 1024, 64), (32, 12, 1024, 64),
                    (2, 12, 8192, 64), SPLASH_SHAPE]


def phase_attention_shapes(dev, shapes=ATTENTION_SHAPES):
    """At each shape ([B, N, S, H], bf16, q/k/v strided bnsh views of one
    fused qkv projection): device ms of the flash forward and of
    scaled_dot_product_attention's forward, causal and not, and of the
    splash forward and dq over the causal map at 128-blocks."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import splash_attention as sp
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd
    for B, N, S, H in shapes:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        q, k, v, do = case_inputs(gen, dev, (B, N, S, H), "bfloat16", True, 4)
        row = {}
        for causal in (True, False):
            tag = "causal" if causal else "full"
            row[f"flash_fwd_{tag}_ms"] = device_ms(
                lambda: flash_attention_fwd(q, k, v, causal, layout="bnsh"),
                "flash_fwd_", 20)
            row[f"sdpa_fwd_{tag}_ms"] = device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=causal),
                None, 20)
        info = sp.process_mask(sp.causal_mha_mask(N, S), (128, 128))
        offsets, rows, _ = info.tensors(dev)
        o, lse = sp._launch_fwd(q, k, v, offsets, rows, 128, 128)
        di = sp._di(o, do)
        row["splash_fwd_ms"] = device_ms(lambda: sp._launch_fwd(
            q, k, v, offsets, rows, 128, 128), "splash_fwd_", 20)
        row["splash_bwd_dq_ms"] = device_ms(lambda: sp._launch_dq(
            q, k, v, do, lse, di, offsets, rows, 128, 128), "splash_dq_", 20)
        emit("attention_shapes", shape=[B, N, S, H], dtype="bfloat16",
             **row)
        del q, k, v, do, o, lse, di


# ------------------------------------------------------------ runtime core

# GPT-2-small's f32 params (498 MB) and two of its f32 logits at [2, 1024]
# (412 MB each) live in the store at once, with headroom.
RUNTIME_STORE_BYTES = 2 << 30
RUNTIME_TOKENS = (2, 1024)


def gpt_fields(cfg) -> dict:
    """A GPTConfig as plain values (dtype by name), so an actor's
    arguments unpickle without importing torch before it times that."""
    return {f.name: (str(getattr(cfg, f.name)).removeprefix("torch.")
                     if f.name == "dtype" else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


class GPTActor:
    """GPT-2 on its worker's card: the weights from the object store, the
    forward on the flash kernels, the logits back through the store.  A
    worker without a card raises (params_from_jax resolves the card)."""

    def __init__(self, tree, fields):
        import os
        t0 = time.perf_counter()
        import torch
        t1 = time.perf_counter()
        check(torch.cuda.is_available(),
              f"GPU actor sees no card (CUDA_VISIBLE_DEVICES="
              f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r})")
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        from ray_tpu_torch.models import GPTConfig, params_from_jax
        self.cfg = GPTConfig(**{**fields,
                                "dtype": getattr(torch, fields["dtype"])})
        self.params = params_from_jax(tree, self.cfg)
        torch.cuda.synchronize()
        self.start = {"import_torch_s": t1 - t0, "cuda_init_s": t2 - t1,
                      "params_s": time.perf_counter() - t2}
        self.logits = None

    def info(self) -> dict:
        import os

        import torch
        return {"cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device": torch.cuda.get_device_name(0),
                "params_device": str(self.params["wte"].device),
                "node_id": os.environ.get("RT_NODE_ID"),
                "reserved_bytes": torch.cuda.memory_reserved(),
                "pid": os.getpid(), **self.start}

    def forward(self, tokens, timed=5) -> dict:
        """One forward kept for ``logits``, then ``timed`` more timed; the
        launch counts are this process's, set to 0 before the first.
        ``ms_total`` is the wall time of all of them, the kept one too."""
        import torch
        from ray_tpu_torch.models import gpt_forward
        tokens = tokens.to("cuda")
        reset_launch_counts()
        t0 = time.perf_counter()
        self.logits = gpt_forward(self.params, tokens, self.cfg)
        torch.cuda.synchronize()
        times = [(time.perf_counter() - t0) * 1e3]
        for _ in range(timed):
            t0 = time.perf_counter()
            gpt_forward(self.params, tokens, self.cfg)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return {"launches": launch_counts(), "forwards": timed + 1,
                "ms": statistics.median(times[1:]) if timed else None,
                "ms_total": sum(times)}

    def forward_auto(self, tokens) -> dict:
        """One forward with attention="auto", held to the kept flash
        logits; its launches, and this process's autotune counters after
        they are flushed to the GCS."""
        import torch
        from ray_tpu_torch.autotune import metrics as autotune_metrics
        from ray_tpu_torch.models import gpt_forward
        from ray_tpu_torch.util import metrics as user_metrics
        reset_launch_counts()
        logits = gpt_forward(self.params, tokens.to("cuda"),
                             dataclasses.replace(self.cfg, attention="auto"))
        torch.cuda.synchronize()
        launches = launch_counts()
        user_metrics.flush()
        return {"launches": launches, "autotune": autotune_metrics.stats(),
                "same_as_flash": bool(torch.equal(logits, self.logits))}

    def get_logits(self):
        return self.logits


def cpu_probe(t):
    """What a worker without a card sees of a tensor sent from a card."""
    import os

    import torch
    return {"cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "cuda_available": torch.cuda.is_available(),
            "device": t.device.type, "dtype": str(t.dtype),
            "shape": list(t.shape), "sha256": tensor_sha256(t)}


def tensor_sha256(t) -> str:
    import hashlib

    import torch
    raw = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()


def noop():
    return None


def in_process_forward(dev, cfg, tree, tokens, timed=5):
    """The driver's own bf16 flash forward on the same params and tokens:
    (logits, median ms, bf16 flash against f32 dense max |err|)."""
    import torch
    from ray_tpu_torch.models import gpt_forward, params_from_jax
    params = params_from_jax(tree, cfg, device=dev)
    tokens = tokens.to(dev)
    logits = gpt_forward(params, tokens, cfg)
    f32 = gpt_forward(params, tokens, dataclasses.replace(
        cfg, dtype=torch.float32, attention="dense"))
    err = float((logits - f32).abs().max())
    del f32
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        gpt_forward(params, tokens, cfg)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return logits, statistics.median(times), err


def runtime_steps(dev, cfg, tree, tokens, limit=None) -> dict:
    """Steps 3-7 of the runtime phase on a running cluster: the params
    through the store to a num_gpus=1 actor, its forward, the observers
    (``observe_first_actor``, ``observe_records``), the second actor
    waiting on the card, and a task without a card.  ``limit`` bounds the
    actor's logits against the in-process forward's when they are not
    bit-identical (default: the in-process bf16-against-f32 error).
    Returns the phase's numbers, the actor's launch counts among them and
    the runtime_observe numbers under ``observe``."""
    import os

    import torch

    import ray_tpu_torch as rt
    fields = gpt_fields(cfg)
    want_visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0")
    params_bytes = sum(v.nbytes for v in _numpy_leaves(tree))
    out = {"params_bytes": params_bytes}

    t0 = time.perf_counter()
    tree_ref = rt.put(tree)
    out["put_params_GBps"] = params_bytes / (time.perf_counter() - t0) / 1e9
    t0 = time.perf_counter()
    rt.get(tree_ref)
    out["get_params_GBps"] = params_bytes / (time.perf_counter() - t0) / 1e9
    # The same tree as CPU tensors: a got tensor is a copy (numpy arrays
    # are read-only views of the store), which is what this costs.
    tensors = _tensor_tree(tree)
    t0 = time.perf_counter()
    tensors_ref = rt.put(tensors)
    out["put_params_tensors_GBps"] = params_bytes / (time.perf_counter() -
                                                     t0) / 1e9
    t0 = time.perf_counter()
    got = rt.get(tensors_ref)
    out["get_params_tensors_GBps"] = params_bytes / (time.perf_counter() -
                                                     t0) / 1e9
    check(torch.equal(got["wte"], tensors["wte"]), "tensor tree changed")
    del tensors, tensors_ref, got

    # The observers (runtime_observe): the "actors" channel's events from
    # before the first GPU actor starts.
    from ray_tpu_torch.util import pubsub
    actor_events = []
    pubsub.subscribe("actors", lambda ev: actor_events.append(
        (ev.get("event"), (ev.get("actor") or {}).get("actor_id"))))

    actor_cls = rt.remote(GPTActor)
    t0 = time.perf_counter()
    first = actor_cls.options(num_gpus=1).remote(tree_ref, fields)
    info = rt.get(first.info.remote(), timeout=600)
    out["actor_cold_start_s"] = time.perf_counter() - t0
    out["actor"] = info
    check(info["cuda_visible_devices"] == want_visible,
          f"GPU actor's CUDA_VISIBLE_DEVICES is "
          f"{info['cuda_visible_devices']!r}, not {want_visible!r}")
    check(info["params_device"] == "cuda:0", "actor params not on cuda:0")

    fwd = rt.get(first.forward.remote(tokens), timeout=600)
    per_fwd = cfg.num_layers
    check(fwd["launches"] == (per_fwd * fwd["forwards"], 0, 0, 0, 0, 0),
          f"the actor's {fwd['forwards']} forwards launched "
          f"{dict(zip(KERNEL_NAMES, fwd['launches']))}")
    logits_ref = first.get_logits.remote()
    rt.wait([logits_ref], timeout=600)
    t0 = time.perf_counter()
    logits = rt.get(logits_ref)
    get_s = time.perf_counter() - t0
    logits_bytes = logits.numel() * logits.element_size()
    check(isinstance(logits, torch.Tensor) and logits.device == dev,
          f"the actor's logits came back on {logits.device}, not {dev}")
    check(logits.dtype == torch.float32 and
          tuple(logits.shape) == (*tokens.shape, cfg.vocab_size),
          f"actor logits {logits.dtype} {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "actor logits not finite")
    out["get_logits_GBps"] = logits_bytes / get_s / 1e9
    t0 = time.perf_counter()
    again = rt.put(logits)
    out["put_logits_GBps"] = logits_bytes / (time.perf_counter() - t0) / 1e9
    t0 = time.perf_counter()
    check(torch.equal(rt.get(again), logits), "logits put/get changed them")
    out["get_logits_again_GBps"] = logits_bytes / (time.perf_counter() -
                                                   t0) / 1e9
    del again

    ref_logits, ref_ms, bf16_err = in_process_forward(dev, cfg, tree, tokens)
    limit = bf16_err if limit is None else min(limit, bf16_err)
    same = torch.equal(logits, ref_logits)
    diff = 0.0 if same else float((logits - ref_logits).abs().max())
    del ref_logits
    out.update(actor_launches=fwd["launches"], actor_forwards=fwd["forwards"],
               actor_forward_ms=fwd["ms"], in_process_forward_ms=ref_ms,
               bit_identical=same, max_abs_diff_vs_in_process=diff,
               limit=limit, in_process_bf16_vs_f32=bf16_err)
    check(same or diff <= limit,
          f"actor logits differ from the in-process forward's by {diff} "
          f"(limit {limit})")
    observe, traced, auto = observe_first_actor(first, tokens, cfg)
    forward_calls = [fwd, traced]

    # The card is held: a second one-card actor waits for the first.
    second = actor_cls.options(num_gpus=1).remote(tree_ref, fields)
    second_info = second.info.remote()
    ready, _ = rt.wait([second_info], timeout=2)
    check(ready == [], "a second num_gpus=1 actor started while the first "
          "held the only card")
    rt.kill(first)
    t0 = time.perf_counter()
    info2 = rt.get(second_info, timeout=600)
    out["second_actor_start_after_kill_s"] = time.perf_counter() - t0
    check(info2["cuda_visible_devices"] == want_visible,
          "second actor's CUDA_VISIBLE_DEVICES")
    fwd2 = rt.get(second.forward.remote(tokens), timeout=600)
    check(fwd2["launches"] == (per_fwd * fwd2["forwards"], 0, 0, 0, 0, 0),
          f"the second actor launched {fwd2['launches']}")
    logits2_ref = second.get_logits.remote()
    check(torch.equal(rt.get(logits2_ref), logits),
          "the second actor's logits differ from the first's")
    forward_calls.append(fwd2)
    out["actor_launches"] = tuple(map(sum, zip(
        auto["launches"], *(c["launches"] for c in forward_calls))))
    out["actor_forwards"] = 1 + sum(c["forwards"] for c in forward_calls)
    records = observe_records(first, second, forward_calls, actor_events)
    observe["wall_ms"].update(records.pop("wall_ms"))
    out["observe"] = {**observe, **records}

    # A task without a card gets the CUDA logits as an equal CPU tensor.
    probe = rt.get(rt.remote(num_gpus=0)(cpu_probe).remote(logits2_ref),
                   timeout=600)
    check(probe["cuda_visible_devices"] == "" and
          not probe["cuda_available"], f"CPU task saw a card: {probe}")
    check(probe["device"] == "cpu" and probe["dtype"] == "torch.float32" and
          probe["sha256"] == tensor_sha256(logits),
          f"CPU task's logits differ: {probe}")
    rt.kill(second)
    del logits, logits2_ref

    task = rt.remote(noop)
    rt.get(task.remote())
    n = 50
    t0 = time.perf_counter()
    for _ in range(n):
        rt.get(task.remote())
    out["empty_task_round_trip_us"] = (time.perf_counter() - t0) / n * 1e6
    return out


def timed_call(walls, key, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall ms kept in ``walls[key]``."""
    t0 = time.perf_counter()
    result = fn(*args, **kwargs)
    walls[key] = (time.perf_counter() - t0) * 1e3
    return result


def observe_first_actor(first, tokens, cfg):
    """The observers on the live first GPU actor: one forward under a
    driver span (the actor's span must come back as its child from
    get_spans), then one forward with attention="auto", whose autotune
    counters must reach autotune_totals() through the metrics sink.
    Returns (the runtime_observe numbers so far, the traced call's
    result, the auto call's result)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.autotune import metrics as autotune_metrics
    from ray_tpu_torch.util import state, tracing
    walls = {}
    tracing.enable()
    with tracing.span("driver:forward") as (trace_id, root_id):
        traced = rt.get(first.forward.remote(tokens, timed=0), timeout=600)
    tracing.disable()
    deadline = time.monotonic() + 30
    while True:
        spans = timed_call(walls, "get_spans", tracing.get_spans,
                           trace_id=trace_id)
        if len(spans) >= 2 or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    by_name = {sp["name"]: sp for sp in spans}
    check(set(by_name) == {"driver:forward", "actor:forward"} and
          len(spans) == 2, f"trace {trace_id} holds {sorted(by_name)}")
    check(by_name["driver:forward"]["parent_id"] is None and
          by_name["driver:forward"]["span_id"] == root_id and
          by_name["actor:forward"]["parent_id"] == root_id,
          f"the actor's span is not the driver span's child: {spans}")

    auto = rt.get(first.forward_auto.remote(tokens), timeout=600)
    check(auto["launches"] == (cfg.num_layers, 0, 0, 0, 0, 0) and
          auto["same_as_flash"],
          f"attention='auto' in the actor: {auto}")
    # The driver's own counters (its autotune phase) flush through the same
    # sink once it is connected, so the totals are the driver's plus the
    # actor's; the raylets tune nothing.
    mine = autotune_metrics.stats()
    want = {k: mine[k] + auto["autotune"][k] for k in mine}

    def summed(totals):
        # stats() rounds the tuning ms to 3 decimals in each process
        return totals.keys() == want.keys() and all(
            abs(totals[k] - want[k]) <= (1e-3 if k.endswith("_ms") else 0)
            for k in want)

    deadline = time.monotonic() + 30
    while True:
        totals = timed_call(walls, "autotune_totals", state.autotune_totals)
        if summed(totals) or time.monotonic() > deadline:
            break
        time.sleep(0.5)
    check(summed(totals), f"autotune_totals() {totals} is not the driver's "
          f"{mine} plus the actor's {auto['autotune']}")
    observe = {"trace_id": trace_id, "spans": len(spans),
               "actor_span_ms": (by_name["actor:forward"]["end"] -
                                 by_name["actor:forward"]["start"]) * 1e3,
               "autotune_actor": auto["autotune"],
               "autotune_driver": mine, "autotune_totals": totals,
               "auto_launches": auto["launches"], "wall_ms": walls}
    return observe, traced, auto


def observe_records(first, second, forward_calls, actor_events):
    """The state API after the first actor's kill and the second's
    forward: both GPU actors in list_actors() (first DEAD, second ALIVE,
    each with GPU: 1), one FINISHED list_tasks entry and one timeline "X"
    event per forward call, each event at least as long as the actor's own
    ms for that call, the node's card in list_nodes(), node_stats() and
    cluster_summary(), and the first actor's alive event before its dead
    one on the "actors" channel."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.util import state
    walls = {}
    ids = (first._actor_id, second._actor_id)
    deadline = time.monotonic() + 30
    while ("dead", ids[0]) not in actor_events:
        check(time.monotonic() < deadline, f"no dead event for the killed "
              f"actor on the actors channel: {actor_events}")
        time.sleep(0.1)
    mine = [e for e, a in actor_events if a == ids[0]]
    check(mine.index("alive") < mine.index("dead"),
          f"the first actor's events came as {mine}")
    actors = {a["actor_id"]: a for a in timed_call(walls, "list_actors",
                                                   state.list_actors)}
    for aid, want in zip(ids, ("DEAD", "ALIVE")):
        rec = actors.get(aid) or {}
        check(rec.get("state") == want and
              rec.get("resources", {}).get("GPU") == 1,
              f"list_actors() shows {rec}, not {want} with GPU: 1")
    n_calls = len(forward_calls)
    deadline = time.monotonic() + 30
    while True:
        tasks = timed_call(walls, "list_tasks", state.list_tasks,
                           name="forward", kind="actor_call")
        if len(tasks) >= n_calls or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    check(len(tasks) == n_calls and
          all(t["status"] == "FINISHED" for t in tasks),
          f"list_tasks(name='forward') holds "
          f"{[(t['actor_id'], t['status']) for t in tasks]}, not "
          f"{n_calls} FINISHED calls")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "timeline.json")
        timed_call(walls, "timeline", rt.timeline, path)
        with open(path) as f:
            events = [e for e in json.load(f) if e["name"] == "forward"]
    events.sort(key=lambda e: e["ts"])
    # The calls ran one after another, first's two then second's one.
    want_tids = [ids[0]] * (n_calls - 1) + [ids[1]]
    check([e["ph"] for e in events] == ["X"] * n_calls and
          [e["tid"] for e in events] == want_tids,
          f"timeline 'forward' events {[(e['ph'], e['tid']) for e in events]}")
    durs_ms = [e["dur"] / 1e3 for e in events]
    own_ms = [c["ms_total"] for c in forward_calls]
    check(all(d >= o for d, o in zip(durs_ms, own_ms)),
          f"timeline durations {durs_ms} ms are shorter than the actor's "
          f"own {own_ms} ms")
    nodes = [n for n in timed_call(walls, "list_nodes", state.list_nodes)
             if n["alive"]]
    stats = timed_call(walls, "node_stats", state.node_stats)
    summary = timed_call(walls, "cluster_summary", state.cluster_summary)
    check(len(nodes) == 1 and nodes[0]["resources_total"].get("GPU") == 1,
          f"list_nodes() shows {nodes}")
    node_id = nodes[0]["node_id"]
    workers = {w.get("actor_id") for w in stats.get(node_id, {}).get(
        "workers", [])}
    check(ids[1] in workers, f"node_stats() lists no worker of the live "
          f"GPU actor on {node_id[:12]}")
    check(summary["resources"]["total"].get("GPU") == 1 and
          summary["actors"]["total"] >= 2 and summary["nodes"]["alive"] == 1,
          f"cluster_summary() shows {summary}")
    return {"actors_channel": mine, "list_tasks_forward": len(tasks),
            "timeline_forward_ms": durs_ms, "actor_forward_ms": own_ms,
            "node_gpu_total": nodes[0]["resources_total"]["GPU"],
            "summary_gpu_total": summary["resources"]["total"]["GPU"],
            "wall_ms": walls}


# The head's GCS holds a node whose connection dropped for this long before
# it records the node dead (node_reconnect_grace_s, 30 s by default): the
# node-death step sets it short, and its line names the value.
NODE_DEATH_GRACE_S = 5.0


def smi_query(*args) -> list:
    """nvidia-smi's CSV rows (no header, no units) for one query."""
    out = subprocess.run(
        ["nvidia-smi", *args, "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [[c.strip() for c in line.split(",")]
            for line in out.splitlines() if line.strip()]


def card_apps() -> dict:
    """pid -> MiB of each process nvidia-smi lists on the card."""
    return {int(pid): int(mib) for pid, mib in smi_query(
        "--query-compute-apps=pid,used_memory") if pid.isdigit()}


def card_used_mib() -> int:
    return int(smi_query("--query-gpu=memory.used")[0][0])


def process_gone(pid: int) -> bool:
    """True once ``pid`` has exited (a zombie holds no card memory)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] in ("Z", "X")
    except FileNotFoundError:
        return True


def runtime_node_death(dev, cfg, tree, tokens) -> dict:
    """A num_gpus=1 GPT actor (max_restarts=1) survives its node's death,
    on a cluster_utils.Cluster: a head that advertises no card (a Cluster's
    nodes detect none; the head is given none) and a worker node given the
    card.  NodeKiller SIGKILLs the worker node's daemon and wait_node_dead
    sees the GCS record it; every process of the dead node must exit, and
    none may still hold the card's memory (nvidia-smi's compute apps and
    memory.used); a new node with the card joins, the actor restarts there
    and its logits are bit-identical to its logits before the kill."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.exceptions import ActorError, GetTimeoutError
    from ray_tpu_torch.util import fault_injection, state
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0")
    check(visible == "0", f"CUDA_VISIBLE_DEVICES={visible!r}: a Cluster "
          f"node given one card names it 0")
    out = {"reconnect_grace_s": NODE_DEATH_GRACE_S}
    t0 = time.perf_counter()
    cluster = Cluster(head_node_args={
        "num_cpus": 2, "object_store_memory": RUNTIME_STORE_BYTES,
        "env": {"RT_NODE_RECONNECT_GRACE_S": str(NODE_DEATH_GRACE_S)}})
    try:
        rt.init(address=cluster.address)
        head_res = rt.cluster_resources()
        check(head_res.get("GPU", 0) == 0,
              f"the head advertises a card: {head_res}")
        node = cluster.add_node(num_cpus=2, resources={"GPU": 1.0},
                                object_store_memory=RUNTIME_STORE_BYTES)
        cluster.wait_for_nodes()
        check(rt.cluster_resources().get("GPU") == 1.0,
              f"the cluster advertises {rt.cluster_resources()}")
        out["cluster_start_s"] = time.perf_counter() - t0
        actor = rt.remote(GPTActor).options(num_gpus=1, max_restarts=1).remote(
            rt.put(tree), gpt_fields(cfg))
        t0 = time.perf_counter()
        info = rt.get(actor.info.remote(), timeout=600)
        out["actor_cold_start_s"] = time.perf_counter() - t0
        check(info["node_id"] == node.node_id and
              info["cuda_visible_devices"] == "0",
              f"the GPU actor runs on {info['node_id']} with "
              f"CUDA_VISIBLE_DEVICES={info['cuda_visible_devices']!r}")
        fwd = rt.get(actor.forward.remote(tokens, timed=0), timeout=600)
        check(fwd["launches"] == (cfg.num_layers, 0, 0, 0, 0, 0),
              f"the actor's forward launched {fwd['launches']}")
        before = rt.get(actor.get_logits.remote(), timeout=600)
        reserved = rt.get(actor.info.remote(), timeout=60)["reserved_bytes"]
        apps_before = card_apps()
        used_before = card_used_mib()
        dead_pids = [info["pid"], node.proc.pid]

        killer = fault_injection.NodeKiller()
        t0 = time.perf_counter()
        killed = killer.kill_node(node.node_id, wait=False)
        check(killed["pid"] == node.proc.pid,
              f"NodeKiller killed pid {killed['pid']}, not the node's "
              f"{node.proc.pid}")
        fault_injection.wait_node_dead(node.node_id, timeout=120)
        out["detect_s"] = time.perf_counter() - t0
        deadline = time.monotonic() + 60
        while not all(process_gone(p) for p in dead_pids) or (
                set(card_apps()) & set(dead_pids)):
            check(time.monotonic() < deadline,
                  f"a process of the dead node lives on or holds the card: "
                  f"{[p for p in dead_pids if not process_gone(p)]}, "
                  f"{card_apps()}")
            time.sleep(0.2)
        out["card_freed_s"] = time.perf_counter() - t0
        apps_after = card_apps()
        used_after = card_used_mib()
        check(used_before - used_after >= reserved // 2**20,
              f"the card's memory.used fell from {used_before} to "
              f"{used_after} MiB, less than the dead actor's "
              f"{reserved // 2**20} MiB reserved")

        t0 = time.perf_counter()
        new = cluster.add_node(num_cpus=2, resources={"GPU": 1.0},
                               object_store_memory=RUNTIME_STORE_BYTES)
        out["node_join_s"] = time.perf_counter() - t0
        deadline = time.monotonic() + 600
        while True:
            try:
                info2 = rt.get(actor.info.remote(), timeout=30)
            except (ActorError, GetTimeoutError):
                info2 = None
            if info2 is not None and info2["node_id"] == new.node_id:
                break
            check(time.monotonic() < deadline,
                  f"the actor never restarted on {new.node_id[:12]}")
            time.sleep(0.2)
        out["restart_s"] = time.perf_counter() - t0
        fwd2 = rt.get(actor.forward.remote(tokens, timed=0), timeout=600)
        after = rt.get(actor.get_logits.remote(), timeout=600)
        check(fwd2["launches"] == fwd["launches"],
              f"the restarted actor launched {fwd2['launches']}")
        check(after.dtype == before.dtype and torch.equal(after, before),
              "the restarted actor's logits differ from its logits before "
              "the kill")
        rec = next(a for a in state.list_actors()
                   if a["actor_id"] == actor._actor_id)
        check(rec["state"] == "ALIVE" and rec["num_restarts"] == 1,
              f"list_actors() shows {rec}")
        rt.kill(actor)
        out.update(
            actor_launches=tuple(a + b for a, b in zip(fwd["launches"],
                                                        fwd2["launches"])),
            restart_import_torch_s=info2["import_torch_s"],
            restart_cuda_init_s=info2["cuda_init_s"],
            restart_params_s=info2["params_s"],
            first_start=info, dead_pids=dead_pids,
            actor_reserved_mib=reserved / 2**20,
            card_used_mib_before_kill=used_before,
            card_used_mib_after_kill=used_after,
            card_apps_before_kill=apps_before, card_apps_after_kill=apps_after,
            # nvidia-smi names processes by pid as the host sees them: in
            # a container its list may match no pid here (the memory
            # check then carries the card's half of the proof)
            card_apps_name_this_process=os.getpid() in apps_before,
            bit_identical_after_restart=True)
    finally:
        rt.shutdown()
        cluster.shutdown()
    return out


def _tensor_tree(tree):
    import torch
    return {k: _tensor_tree(v) if isinstance(v, dict) else
            torch.from_numpy(v) for k, v in tree.items()}


def _numpy_leaves(tree):
    for v in tree.values():
        yield from (_numpy_leaves(v) if isinstance(v, dict) else [v])


def shm_free_bytes() -> int:
    st = os.statvfs("/dev/shm")
    return st.f_bavail * st.f_frsize


# ------------------------------------------------------------- serving

# runtime_serve's flash deployment: rows of 1024 tokens, batched up to 4.
SERVE_FLASH_ROWS = 8
SERVE_FLASH_BATCH = 4


def _serve_classes():
    """The two deployments of runtime_serve, made where serve is imported
    (the classes travel to their replicas by value with cloudpickle).

    ``ServeLLM`` is ``LLMServer`` with its params pulled from the object
    store in ``__init__``: the deployment's args go to the controller and
    into its KV checkpoint, so they carry an ObjectRef in a list, never
    the 0.5 GB tree.  ``FlashServe`` runs GPT-2's bf16 flash forward on
    rows of tokens batched by ``@serve.batch`` and returns each row's
    last-position logits as a CPU tensor."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.engine import LLMServer

    def pull_params(box, fields, device):
        """(cfg, params on the card, seconds) from a boxed tree ref."""
        import torch

        import ray_tpu_torch as rt
        from ray_tpu_torch.models import GPTConfig, params_from_jax
        t0 = time.perf_counter()
        cfg = GPTConfig(**{**fields,
                           "dtype": getattr(torch, fields["dtype"])})
        params = params_from_jax(rt.get(box[0], timeout=600), cfg,
                                 device=device)
        if params["wte"].device.type == "cuda":
            torch.cuda.synchronize()
        return cfg, params, time.perf_counter() - t0

    def started_at() -> float:
        """This process's start, on the time.time() clock."""
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")

    class ServeLLM(LLMServer):
        def __init__(self, box, fields, sizes, device=None):
            import torch

            from ray_tpu_torch.serve.engine import EngineConfig
            # Unpickling this class and its args imported torch, before
            # __init__: the seconds from process start to here hold the
            # interpreter's start, the worker's connect and that import.
            t_init = time.time()
            to_init_s = t_init - started_at()
            cfg, params, params_s = pull_params(box, fields, device)
            t0 = time.perf_counter()
            super().__init__(EngineConfig(model_config=cfg, device=device,
                                          **sizes), params=params)
            if self._engine.device.type == "cuda":
                torch.cuda.synchronize()
            self.start = {
                "to_init_s": to_init_s, "params_s": params_s,
                "engine_s": time.perf_counter() - t0,
                "cuda_visible_devices": os.environ.get(
                    "CUDA_VISIBLE_DEVICES"),
                "engine_device": str(self._engine.device),
                "pid": os.getpid()}

        def start_info(self) -> dict:
            return self.start

        async def timed(self, payload):
            """One request on the replica's own engine, in its process:
            (tokens, seconds to the first token, seconds to the last)."""
            t0, first, toks = time.perf_counter(), None, []
            async for tok in self._engine.generate(
                    payload["tokens"], payload.get("max_new_tokens")):
                if first is None:
                    first = time.perf_counter() - t0
                toks.append(tok)
            return toks, first, time.perf_counter() - t0

    class FlashServe:
        def __init__(self, box, fields, device=None):
            cfg, params, params_s = pull_params(box, fields, device)
            self.cfg, self.params = cfg, params
            self.batch_sizes = []
            self.start = {"params_s": params_s, "pid": os.getpid(),
                          "cuda_visible_devices": os.environ.get(
                              "CUDA_VISIBLE_DEVICES")}

        @serve.batch(max_batch_size=SERVE_FLASH_BATCH,
                     batch_wait_timeout_s=0.05)
        async def forward(self, rows):
            import torch

            from ray_tpu_torch.models import gpt_forward
            self.batch_sizes.append(len(rows))
            tokens = torch.tensor(rows, device=self.params["wte"].device)
            with torch.no_grad():
                logits = gpt_forward(self.params, tokens, self.cfg)
            return list(logits[:, -1].float().cpu().unbind(0))

        async def __call__(self, row):
            return await self.forward(row)

        def start_info(self) -> dict:
            return self.start

        def reset(self):
            reset_launch_counts()
            self.batch_sizes = []

        def launches(self) -> dict:
            return {"launches": launch_counts(),
                    "batch_sizes": list(self.batch_sizes)}

    return ServeLLM, FlashServe


def sse_request(url, route, payload, timeout=600):
    """One SSE session over a raw socket: (tokens, seconds to the first
    token, seconds to the end)."""
    import socket
    host, port = url.split("//")[1].split(":")
    body = json.dumps({**payload, "stream": True}).encode()
    t0 = time.perf_counter()
    first = None
    with socket.create_connection((host, int(port)), timeout=timeout) as s:
        s.sendall(f"POST {route} HTTP/1.1\r\nHost: x\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        buf = b""
        while b"event: end" not in buf or not buf.endswith(b"0\r\n\r\n"):
            c = s.recv(65536)
            check(c, f"SSE stream closed early: {buf[-300:]!r}")
            buf += c
            if first is None and b"data: " in buf:
                first = time.perf_counter() - t0
            check(b"event: error" not in buf,
                  f"SSE error event: {buf[-300:]!r}")
    total = time.perf_counter() - t0
    events = [line for line in buf.replace(b"\r\n", b"\n").split(b"\n")
              if line.startswith(b"data: ")]
    return [json.loads(e[6:]) for e in events][:-1], first, total


def http_json(url, timeout=30):
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def first_divergence(a, b) -> int:
    """Index of the first token where two streams differ (len if none)."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def runtime_serve(dev, cfg, tree, dashboard, limit, serve_cfg=None,
                  serve_phase=None):
    """Serve on the runtime phase's cluster (see the module docstring):
    (a) an LLMServer replica with num_gpus=1 streams over HTTP, held to an
    in-process engine on the same params and prompts; (b) a num_gpus=1
    replica runs the bf16 flash forward under @serve.batch, held to the
    in-process forward.  ``serve_phase`` (the serve phase's numbers) is
    printed beside the step's.  Returns the step's numbers; the flash
    replica's launch counts under ``flash_launches``."""
    import threading

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import gpt_forward, params_from_jax
    from ray_tpu_torch.util import state

    serve_cfg = serve_cfg or SERVE
    ServeLLM, FlashServe = _serve_classes()
    on_card = dev.type == "cuda"
    remote_dev = None if on_card else "cpu"   # the replica's own card
    sizes = (serve_cfg["page"], serve_cfg["max_prompt"],
             serve_cfg["max_new"], serve_cfg["max_batch"])
    max_prompt, max_new = sizes[1], sizes[2]
    # The engine prefills dense (gpt_prefill) and decodes paged, in bf16.
    ecfg = dataclasses.replace(cfg, dtype=torch.bfloat16, attention="dense")
    prompts = _prompts(serve_cfg["n_req"], serve_cfg["prompt_lo"],
                       max_prompt, cfg.vocab_size)
    params = params_from_jax(tree, cfg, device=dev)
    out = {}
    if serve_phase is not None:
        out["serve_phase"] = {
            "tokens_per_s": serve_phase["bf16_tokens_per_s"],
            "p50_ttft_ms": serve_phase["bf16_p50_ttft_ms"]}

    # The yardstick: the in-process engine, on the same tree and prompts,
    # before the replica shares the card (a warm-up request first).
    _serve_once(dev, ecfg, params, prompts[1:2], *sizes)
    ref, wall, _ = _serve_once(dev, ecfg, params, prompts, *sizes)
    out["in_process"] = {
        "tokens_per_s": sum(len(t) for t, _, _ in ref) / wall,
        "p50_ttft_ms": statistics.median(f for _, f, _ in ref) * 1e3}

    tree_ref = rt.put(tree)
    fields = gpt_fields(ecfg)
    try:
        # (a) LLMServer over HTTP from a num_gpus=1 replica.
        dep = serve.deployment(
            name="llm", max_concurrent_queries=2 * serve_cfg["n_req"],
            ray_actor_options={"num_cpus": 1, "num_gpus": 1})(ServeLLM)
        t0 = time.perf_counter()
        handle = serve.run(dep.bind([tree_ref], fields,
                                    engine_kwargs(*sizes), remote_dev))
        start = rt.get(handle.method("start_info").remote(), timeout=900)
        out["llm_cold_start_s"] = time.perf_counter() - t0
        out["llm_replica"] = start
        if on_card:
            check(start["cuda_visible_devices"] == os.environ.get(
                "CUDA_VISIBLE_DEVICES", "0"),
                f"the replica sees {start['cuda_visible_devices']!r}")
            check(start["engine_device"] == "cuda:0",
                  f"the replica's engine is on {start['engine_device']}")
        url = serve.start_http()
        deadline = time.monotonic() + 60
        while "/llm" not in http_json(f"{url}/-/routes"):
            check(time.monotonic() < deadline, "the ingress never saw /llm")
            time.sleep(0.2)
        # One warm request, then the 12 concurrent streams.
        sse_request(url, "/llm", {"tokens": prompts[1],
                                  "max_new_tokens": max_new})
        results = [None] * len(prompts)

        def stream(i):
            try:
                results[i] = sse_request(url, "/llm", {
                    "tokens": prompts[i], "max_new_tokens": max_new})
            except BaseException as e:   # noqa: BLE001 - checked below
                results[i] = e

        threads = [threading.Thread(target=stream, args=(i,), daemon=True)
                   for i in range(len(prompts))]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        http_wall = time.perf_counter() - t0
        for i, r in enumerate(results):
            check(not isinstance(r, BaseException) and r is not None,
                  f"HTTP stream {i} failed: {r!r}")
        check(all(len(t) == max_new for t, _, _ in results),
              f"an HTTP stream was short: {[len(t) for t, _, _ in results]}")
        diverged = {i: first_divergence(t, want)
                    for i, ((t, _, _), (want, _, _))
                    in enumerate(zip(results, ref)) if t != want}
        near_ties = []
        for i, d in diverged.items():
            # A reduction-order difference may flip a near-tie: the two
            # tokens' bf16 logits at the divergence lie within the
            # in-process bf16 logit error (phase_serve's rule).
            seq = torch.tensor([prompts[i] + ref[i][0][:d]], device=dev)
            with torch.no_grad():
                lg = gpt_forward(params, seq, ecfg)[0, -1].float()
            got, want = results[i][0][d], ref[i][0][d]
            gap = float(lg.max() - min(lg[got], lg[want]))
            near_ties.append({"stream": i, "step": d, "gap": gap})
            check(gap <= limit, f"HTTP stream {i} diverges at token {d} "
                  f"({got} != {want}) with a logit gap {gap} > {limit}")
        out["http"] = {
            "streams": len(results), "tokens_each": max_new,
            "identical_streams": len(results) - len(diverged),
            "near_ties": near_ties,
            "tokens_per_s": sum(len(t) for t, _, _ in results) / http_wall,
            "p50_ttft_ms": statistics.median(f for _, f, _ in results) * 1e3}
        # One request alone: on the replica's engine in its own process,
        # through the handle and over HTTP; the differences are the
        # handle's and HTTP's per-request overhead.
        payload = {"tokens": prompts[1], "max_new_tokens": max_new}
        own, handle_ms, http_ms, http_ttft = [], [], [], []
        for _ in range(3):
            toks, first, total = rt.get(
                handle.method("timed").remote(payload), timeout=600)
            own.append((first * 1e3, total * 1e3))
            check(toks == ref[1][0], "the replica's own tokens differ")
            t0 = time.perf_counter()
            toks = rt.get(handle.remote(payload), timeout=600)
            handle_ms.append((time.perf_counter() - t0) * 1e3)
            check(toks == ref[1][0], "the handle's tokens differ")
            toks, first, total = sse_request(url, "/llm", payload)
            check(toks == ref[1][0], "the HTTP stream's tokens differ")
            http_ms.append(total * 1e3)
            http_ttft.append(first * 1e3)
        own_ms = statistics.median(s for _, s in own)
        out["single_request"] = {
            "replica_ttft_ms": statistics.median(f for f, _ in own),
            "replica_total_ms": own_ms,
            "handle_total_ms": statistics.median(handle_ms),
            "http_ttft_ms": statistics.median(http_ttft),
            "http_total_ms": statistics.median(http_ms),
            "handle_overhead_ms": statistics.median(handle_ms) - own_ms,
            "http_overhead_ms": statistics.median(http_ms) - own_ms}
        # The dashboard and the counters agree with the traffic: the
        # deployment running, no retry, ejection, resume or drain.
        deadline = time.monotonic() + 30
        while True:
            deps = http_json(f"http://{dashboard}/api/serve")["deployments"]
            if deps.get("llm", {}).get("running") == 1:
                break
            check(time.monotonic() < deadline, f"/api/serve shows {deps}")
            time.sleep(0.5)
        out["api_serve"] = deps
        # serve_totals() counts failures only (no request counter) and
        # reads 0 for a key no node reports, so first check that every
        # raylet's stats carry the serve fold's counters.
        from ray_tpu_torch.serve.metrics import COUNTER_NAMES
        nodes = state.node_stats()
        check(nodes and all(set(COUNTER_NAMES) <= set(s) for s in
                            nodes.values()),
              f"node stats lack the serve counters {COUNTER_NAMES}: "
              f"{[sorted(s) for s in nodes.values()]}")
        totals = state.serve_totals()
        out["serve_totals"] = totals
        check(not any(totals.values()),
              f"serve_totals() counted failures on clean traffic: {totals}")
        ingress = rt.get(rt.get_actor("_serve_http").stats.remote(),
                         timeout=60)
        check(ingress["shed"] == 0, f"the ingress shed requests: {ingress}")
        out["ingress"] = ingress
        apps_before = smi_query("--query-compute-apps=pid,used_memory") \
            if on_card else []
        serve.delete("llm")
        if on_card:
            # The replica's process exits and its entry leaves nvidia-smi's
            # compute apps (which may list every process as pid 1 in a
            # container, so the entries are counted).
            deadline = time.monotonic() + 60
            while True:
                apps = smi_query("--query-compute-apps=pid,used_memory")
                if process_gone(start["pid"]) and \
                        len(apps) < len(apps_before):
                    break
                check(time.monotonic() < deadline, "the deleted replica "
                      f"{start['pid']} still holds the card: {apps} "
                      f"(before the delete {apps_before})")
                time.sleep(0.2)
            out["card_apps_before_delete"] = apps_before
            out["card_apps_after_delete"] = apps

        # (b) The flash forward through serve, batched.
        dep = serve.deployment(
            name="flash", max_concurrent_queries=2 * SERVE_FLASH_ROWS,
            ray_actor_options={"num_cpus": 1, "num_gpus": 1})(FlashServe)
        t0 = time.perf_counter()
        fh = serve.run(dep.bind([tree_ref], gpt_fields(cfg), remote_dev))
        out["flash_replica"] = rt.get(fh.method("start_info").remote(),
                                      timeout=900)
        out["flash_cold_start_s"] = time.perf_counter() - t0
        gen = torch.Generator().manual_seed(SEED + 1)
        rows = torch.randint(0, cfg.vocab_size,
                             (SERVE_FLASH_ROWS, RUNTIME_TOKENS[1]),
                             generator=gen).tolist()
        rt.get(fh.method("reset").remote(), timeout=60)
        t0 = time.perf_counter()
        got = rt.get([fh.remote(r) for r in rows], timeout=600)
        out["flash_calls_s"] = time.perf_counter() - t0
        counted = rt.get(fh.method("launches").remote(), timeout=60)
        out["flash_launches"] = counted["launches"]
        out["flash_batch_sizes"] = counted["batch_sizes"]
        check(sum(counted["batch_sizes"]) == SERVE_FLASH_ROWS and
              max(counted["batch_sizes"]) > 1,
              f"the flash replica's batches {counted['batch_sizes']}")
        if on_card:
            check(counted["launches"] == (
                cfg.num_layers * len(counted["batch_sizes"]), 0, 0, 0, 0,
                0), f"the flash replica launched {counted['launches']}")
        errs = []
        with torch.no_grad():
            for r, logits in zip(rows, got):
                check(isinstance(logits, torch.Tensor) and
                      logits.device.type == "cpu" and
                      tuple(logits.shape) == (cfg.vocab_size,),
                      f"flash replica returned {type(logits)}")
                want = gpt_forward(params, torch.tensor([r], device=dev),
                                   cfg)[0, -1].float().cpu()
                errs.append(float((logits - want).abs().max()))
        out["flash_max_abs_diff_vs_in_process"] = max(errs)
        out["flash_limit"] = limit
        check(max(errs) <= limit, f"the serve-batched flash forward "
              f"differs from the in-process one by {max(errs)} > {limit}")
        serve.delete("flash")
    finally:
        serve.shutdown()
    return out


# ------------------------------------------------------------ runtime_train

# The trainer's run (see the module docstring): [32, 1024] tokens a step,
# 12 steps, a checkpoint every 4, the recovery run's worker SIGKILLed after
# step 9's report (step 8's checkpoint is then the newest committed one).
RUNTIME_TRAIN_STEPS = 12
RUNTIME_TRAIN_CKPT_EVERY = 4
RUNTIME_TRAIN_KILL_AFTER = 9
RUNTIME_TRAIN_BATCH = (32, 1024)


def train_tokens(vocab_size, step, B, S):
    """The data cursor: step ``step``'s [B, S + 1] tokens, a function of
    the step alone, so a resumed run reads the batches it would have."""
    import torch
    gen = torch.Generator().manual_seed(SEED + 1000 + step)
    return torch.randint(0, vocab_size, (B, S + 1), generator=gen)


def params_sha256(params) -> str:
    """sha256 over every leaf's name and bytes, in the tree's order."""
    import hashlib
    h = hashlib.sha256()
    for name, leaf in named_leaves(params):
        h.update(name.encode())
        h.update(tensor_sha256(leaf).encode())
    return h.hexdigest()


def train_worker_loop(config):
    """The runtime_train step's train_loop_per_worker: GPT-2-small's
    training at ``phase_train``'s settings on the worker's card (weights
    from seed 0, tokens from ``train_tokens``), resumed from the newest
    committed checkpoint of ``config["root"]`` when there is one.  Every
    step reports its loss, its time (the step and its loss's one sync),
    the wall clock and this process's launch counts; a checkpoint step
    also its snapshot stall (``snapshot_to_host``, the only part on the
    step loop) and the submit's wait.  With ``kill_after`` the first
    incarnation waits, after that step's report, for its checkpoint write
    to commit, says so in a file, and waits to be SIGKILLed."""
    import os
    wall0 = time.time()
    t0 = time.perf_counter()
    import torch
    import_s = time.perf_counter() - t0

    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.air import _tensor_tree, session
    from ray_tpu_torch.models import GPTConfig
    from ray_tpu_torch.train._internal import checkpoint_store as cs
    t0 = time.perf_counter()
    dev = resolve_device(config["device"])
    on_card = dev.type == "cuda"
    if on_card:
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    start_info = {
        "wall_loop_start": wall0, "import_torch_s": import_s,
        "cuda_init_s": time.perf_counter() - t0, "pid": os.getpid(),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "device_count": torch.cuda.device_count() if on_card else 0}
    fields = config["fields"]
    cfg = GPTConfig(**{**fields, "dtype": getattr(torch, fields["dtype"])})
    fam = family(cfg)
    t0 = time.perf_counter()
    params, opt = fam.train_state(SEED, cfg, learning_rate=3e-4,
                                  weight_decay=1e-4, device=dev)
    step_fn = fam.train_step(cfg, opt)
    sync(dev)
    start_info["init_s"] = time.perf_counter() - t0
    store = cs.CheckpointStore(config["root"], keep=2)
    writer = cs.AsyncCheckpointWriter(store)
    t0 = time.perf_counter()
    rc = store.restore_latest()
    start = 0
    if rc is not None:
        with torch.no_grad():
            for (_, leaf), (_, saved) in zip(named_leaves(params),
                                             named_leaves(rc.tree["params"])):
                leaf.copy_(saved)
        opt.load_state_dict(rc.tree["opt"])
        rc.restore_host_rng()
        start = rc.data_state
        sync(dev)
        start_info["restore_s"] = time.perf_counter() - t0
    start_info["restored_from"] = start
    start_info["wall_ready"] = time.time()
    writes = []
    B, S = config["batch"]
    reset_launch_counts()
    submitted = 0
    for step in range(start, config["steps"]):
        tokens = train_tokens(cfg.vocab_size, step, B, S).to(dev)
        write_in_flight = len(writes) < submitted
        t0 = time.perf_counter()
        loss = float(step_fn(params, {"tokens": tokens})["loss"])
        rec = {"step": step + 1, "loss": loss,
               "step_ms": (time.perf_counter() - t0) * 1e3,
               "wall": time.time(), "pid": os.getpid(),
               "launches": launch_counts(),
               "write_in_flight": write_in_flight}
        if (step + 1) % config["ckpt_every"] == 0:
            t0 = time.perf_counter()
            host = cs.snapshot_to_host({"params": params,
                                        "opt": opt.state_dict()})
            t1 = time.perf_counter()
            stalls = writer.stalls
            fut = writer.submit(step + 1, host,
                                rng_state=cs.capture_rng_state(),
                                data_state=step + 1)
            submitted += 1
            t_submit = time.perf_counter()
            fut.add_done_callback(
                lambda _, s=step + 1, t=t_submit: writes.append(
                    (s, time.perf_counter() - t)))
            rec.update(snapshot_ms=(t1 - t0) * 1e3,
                       submit_wait_ms=(t_submit - t1) * 1e3,
                       submit_stalled=writer.stalls > stalls,
                       ckpt_bytes=sum(x.nbytes for x in
                                      _tensor_tree.flatten(host)[0]))
        if step == start:
            rec.update(start_info)
        session.report(rec)
        if step + 1 == config.get("kill_after") and rc is None:
            writer.wait()
            with open(os.path.join(config["root"], "ready-to-kill"),
                      "w") as f:
                f.write(str(os.getpid()))
            time.sleep(300)
            raise RuntimeError("the worker was not killed")
    writer.close()
    session.report({"done": True, "params_sha256": params_sha256(params),
                    "writes_s": sorted(writes), "pid": os.getpid(),
                    "launches": launch_counts(),
                    "writer_stalls": writer.stalls})


def _train_fit(cfg, root, device, kill_after=None):
    """One TorchTrainer fit of ``train_worker_loop`` with a num_gpus=1
    worker (a CPU worker for ``device="cpu"``); with ``kill_after`` a
    driver thread SIGKILLs the worker once it says its checkpoint is
    committed, and FailureConfig(max_failures=1) recovers it.  Returns
    (the fit's reports, its wall seconds, the kill record or None)."""
    import threading

    from ray_tpu_torch.air import RunConfig, ScalingConfig
    from ray_tpu_torch.air.config import FailureConfig
    from ray_tpu_torch.train import TorchTrainer
    from ray_tpu_torch.util import fault_injection, state

    killed = {}

    def _killer():
        # The worker writes its pid here once its checkpoint is committed;
        # SIGKILL it when that pid has reached the GCS (before that,
        # kill_train_worker falls back to a GCS kill).
        flag = os.path.join(root, "ready-to-kill")
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline:
            pid = 0
            if os.path.exists(flag):
                with open(flag) as f:
                    pid = int(f.read() or 0)
            if pid and any(w.get("pid") == pid
                           for w in state.list_workers()):
                killed.update(fault_injection.kill_train_worker(
                    mode="sigkill"))
                return
            time.sleep(0.05)

    thread = None
    if kill_after is not None:
        thread = threading.Thread(target=_killer, daemon=True)
        thread.start()
    t0 = time.perf_counter()
    wall0 = time.time()
    result = TorchTrainer(
        train_worker_loop,
        train_loop_config={
            "fields": gpt_fields(cfg), "root": root,
            "device": None if device.type == "cuda" else "cpu",
            "batch": RUNTIME_TRAIN_BATCH if device.type == "cuda"
            else (2, cfg.max_seq_len), "steps": RUNTIME_TRAIN_STEPS,
            "ckpt_every": RUNTIME_TRAIN_CKPT_EVERY,
            "kill_after": kill_after},
        scaling_config=ScalingConfig(num_workers=1,
                                     use_gpu=device.type == "cuda"),
        run_config=RunConfig(failure_config=FailureConfig(
            max_failures=1 if kill_after is not None else 0)),
    ).fit()
    secs = time.perf_counter() - t0
    if thread is not None:
        thread.join(timeout=60)
        check(killed.get("pid") is not None,
              f"the killer never SIGKILLed the worker: {killed}")
    return result.metrics_history, secs, wall0, killed or None


def _incarnations(history):
    """The fit's reports grouped by worker process, in order."""
    out = {}
    for rec in history:
        out.setdefault(rec["pid"], []).append(rec)
    return list(out.values())


def runtime_train(dev, cfg, in_process_ms=None) -> dict:
    """Train on the runtime phase's cluster (see the module docstring): a
    control fit and a recovery fit of GPT-2-small through TorchTrainer
    with a num_gpus=1 worker.  Returns the step's numbers; the workers'
    flash launches under ``launches``."""
    import ray_tpu_torch as rt
    on_card = dev.type == "cuda"
    L = cfg.num_layers if on_card else 0
    per_step = [2 * L, L, L, 0, 0, 0]
    out = {"steps": RUNTIME_TRAIN_STEPS,
           "ckpt_every": RUNTIME_TRAIN_CKPT_EVERY,
           "kill_after": RUNTIME_TRAIN_KILL_AFTER,
           "batch": list(RUNTIME_TRAIN_BATCH) if on_card else None,
           "in_process_ms_per_step": in_process_ms}
    total = [0] * 6
    for name, kill_after in (("control", None),
                             ("recovery", RUNTIME_TRAIN_KILL_AFTER)):
        free_card(on_card)
        apps_before = card_apps() if on_card else {}
        root = tempfile.mkdtemp(prefix="rtt_train_ckpt_")
        try:
            hist, secs, wall0, killed = _train_fit(cfg, root, dev,
                                                   kill_after)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        steps = [r for r in hist if "step" in r]
        done = [r for r in hist if r.get("done")]
        check(len(done) == 1, f"{name}: the fit ended without its final "
              f"report ({len(done)})")
        inc = _incarnations(steps)
        run = {"fit_s": secs, "params_sha256": done[0]["params_sha256"],
               "writes_s": done[0]["writes_s"],
               "writer_stalls": done[0]["writer_stalls"],
               "incarnations": len(inc)}
        first = inc[0][0]
        # Cold start: from the fit's call to the worker ready to step (its
        # process, torch's import, CUDA's init, the weights and optimizer).
        run["cold_start_s"] = first["wall_ready"] - wall0
        run["fit_to_loop_start_s"] = first["wall_loop_start"] - wall0
        for k in ("import_torch_s", "cuda_init_s", "init_s",
                  "cuda_visible_devices", "device_count"):
            run[k] = first[k]
        if on_card:
            check(first["cuda_visible_devices"] == "0" and
                  first["device_count"] == 1,
                  f"{name}: the worker sees {first['cuda_visible_devices']!r}"
                  f" ({first['device_count']} devices), not exactly the "
                  f"card")
        # The losses by step: the last report of each step (the recovery
        # run reports step 9 twice, before the kill and after).
        losses = {r["step"]: r["loss"] for r in steps}
        check(sorted(losses) == list(range(1, RUNTIME_TRAIN_STEPS + 1)),
              f"{name}: steps {sorted(losses)}")
        run["losses"] = [losses[s] for s in sorted(losses)]
        timed = [r["step_ms"] for r in inc[0] if 2 <= r["step"] <= 8]
        run["ms_per_step"] = statistics.median(timed)
        run["step_ms"] = [r["step_ms"] for r in steps]
        run["write_free_step_ms"] = [r["step_ms"] for r in inc[0]
                                     if r["step"] >= 2
                                     and not r["write_in_flight"]]
        ck = [r for r in steps if "snapshot_ms" in r]
        run["ckpt_bytes"] = ck[0]["ckpt_bytes"]
        run["snapshot_ms"] = [r["snapshot_ms"] for r in ck]
        run["submit_wait_ms"] = [r["submit_wait_ms"] for r in ck]
        # Launches in the workers' own processes: each incarnation's last
        # count, exactly per_step for each step it ran.
        for recs in inc:
            n = list(recs[-1]["launches"])
            ran = len(recs)
            check(n == [ran * k for k in per_step],
                  f"{name}: a worker launched {n} in {ran} steps, "
                  f"expected {per_step} a step")
            total = [a + b for a, b in zip(total, n)]
        if killed is not None:
            check(len(inc) == 2, f"recovery: {len(inc)} worker processes")
            again = inc[1][0]
            check(again["restored_from"] == RUNTIME_TRAIN_KILL_AFTER - 1,
                  f"recovery restored step {again['restored_from']}, not "
                  f"{RUNTIME_TRAIN_KILL_AFTER - 1}")
            check(killed["pid"] == inc[0][0]["pid"],
                  f"the killed pid {killed['pid']} is not the first "
                  f"worker's {inc[0][0]['pid']}")
            run["restore_s"] = again["restore_s"]
            run["kill_to_next_step_s"] = again["wall"] - killed["time"]
            run["kill_to_loop_start_s"] = (again["wall_loop_start"] -
                                           killed["time"])
            run["kill_to_ready_s"] = again["wall_ready"] - killed["time"]
            run["recovered_import_torch_s"] = again["import_torch_s"]
        out[name] = run
        free_card(on_card, apps_before=apps_before)
    ctl, rec = out["control"], out["recovery"]
    same_losses = ctl["losses"][RUNTIME_TRAIN_KILL_AFTER - 1:] == \
        rec["losses"][RUNTIME_TRAIN_KILL_AFTER - 1:]
    same_params = ctl["params_sha256"] == rec["params_sha256"]
    out["resume_bit_identical"] = same_losses and same_params
    out["same_losses_all_steps"] = ctl["losses"] == rec["losses"]
    check(same_losses, f"the recovered losses {rec['losses']} differ from "
          f"the control's {ctl['losses']} after the kill")
    check(same_params, "the recovered params differ from the control's")
    check(all(math.isfinite(x) for x in ctl["losses"]),
          f"control losses {ctl['losses']}")
    out["ms_per_step"] = ctl["ms_per_step"]
    out["write_free_step_ms"] = ctl["write_free_step_ms"]
    out["ms_vs_in_process"] = (ctl["ms_per_step"] / in_process_ms
                               if in_process_ms else None)
    out["cold_start_s"] = ctl["cold_start_s"]
    out["ckpt_bytes"] = ctl["ckpt_bytes"]
    out["snapshot_stall_ms"] = statistics.median(
        ctl["snapshot_ms"] + rec["snapshot_ms"])
    out["ckpt_write_s"] = statistics.median(
        [s for _, s in ctl["writes_s"] + rec["writes_s"]])
    out["restore_s"] = rec["restore_s"]
    out["kill_to_next_step_s"] = rec["kill_to_next_step_s"]
    out["launches"] = tuple(total)
    return out


def free_card(on_card, apps_before=None, timeout=60):
    """Wait until the node has its card back (and, after a fit, until
    nvidia-smi lists no more processes on it than before the fit)."""
    import ray_tpu_torch as rt
    if not on_card:
        return
    deadline = time.monotonic() + timeout
    while True:
        free = rt.available_resources().get("GPU") == 1.0
        apps = card_apps()
        if free and (apps_before is None or len(apps) <= len(apps_before)):
            return
        check(time.monotonic() < deadline, f"the card is not free: GPU "
              f"{rt.available_resources().get('GPU')}, apps {apps} "
              f"(before {apps_before})")
        time.sleep(0.2)

# ------------------------------------------------------------- runtime_data

# The Dataset the trainer reads: 16 blocks of 32 windows of [32, 1024]'s
# length plus the target token, shuffled push-based; one step per batch of
# 32, so 16 steps.  The losses of the trainer and of an in-process run on
# the same batches agree within DATA_LOSS_RTOL (the same code on the same
# card; whether they are bit-identical is printed).
RUNTIME_DATA_BLOCKS = 16
DATA_LOSS_RTOL = 1e-3


def data_windows(vocab_size, B, S):
    """The Dataset's rows: RUNTIME_DATA_BLOCKS * B windows of S + 1
    tokens, from seed 2000."""
    import numpy as np
    gen = np.random.default_rng(SEED + 2000)
    return gen.integers(0, vocab_size, (RUNTIME_DATA_BLOCKS * B, S + 1),
                        dtype=np.int64)


def tokens_sha256(arr) -> str:
    import hashlib

    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def data_worker_loop(config):
    """The runtime_data step's train_loop_per_worker: GPT-2-small at
    ``phase_train``'s settings on the worker's card (weights from seed 0),
    one step per batch of the trainer's dataset shard through
    ``iter_device_batches``.  Every step reports its loss, its time (the
    step and its loss's one sync), how long the loop waited for the batch
    and the sha256 of the batch's tokens; the last report adds the launch
    counts and the ingest's bytes, copy times, host submit times and
    pinned buffers."""
    import os
    wall0 = time.time()
    import torch

    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.air import session
    from ray_tpu_torch.models import GPTConfig
    from ray_tpu_torch.train.data_parallel_trainer import get_dataset_shard
    dev = resolve_device(config["device"])
    fields = config["fields"]
    cfg = GPTConfig(**{**fields, "dtype": getattr(torch, fields["dtype"])})
    fam = family(cfg)
    params, opt = fam.train_state(SEED, cfg, learning_rate=3e-4,
                                  weight_decay=1e-4, device=dev)
    step_fn = fam.train_step(cfg, opt)
    sync(dev)
    start_info = {"wall_loop_start": wall0, "wall_ready": time.time(),
                  "pid": os.getpid(),
                  "cuda_visible_devices": os.environ.get(
                      "CUDA_VISIBLE_DEVICES")}
    batches = get_dataset_shard("train").iter_device_batches(
        batch_size=config["batch"], device=config["device"])
    reset_launch_counts()
    step = 0
    while True:
        t0 = time.perf_counter()
        batch = next(batches, None)
        wait_ms = (time.perf_counter() - t0) * 1e3
        if batch is None:
            break
        tokens = batch["data"]
        t0 = time.perf_counter()
        loss = float(step_fn(params, {"tokens": tokens})["loss"])
        step_ms = (time.perf_counter() - t0) * 1e3
        step += 1
        rec = {"step": step, "loss": loss, "step_ms": step_ms,
               "wait_ms": wait_ms, "sha256": tokens_sha256(
                   tokens.cpu().numpy())}
        if step == 1:
            rec.update(start_info)
        session.report(rec)
    session.report({"done": True, "launches": launch_counts(),
                    "h2d_bytes": batches.bytes_copied,
                    "copy_ms": batches.copy_ms(),
                    "submit_ms": batches.submit_ms,
                    "pinned_allocs": batches.pinned_allocs,
                    "batches": batches.batches})


def in_process_data_losses(dev, cfg, host_batches):
    """The same init's losses on ``host_batches`` in this process."""
    import torch
    fam = family(cfg)
    params, opt = fam.train_state(SEED, cfg, learning_rate=3e-4,
                                  weight_decay=1e-4, device=dev)
    step_fn = fam.train_step(cfg, opt)
    losses = [float(step_fn(params, {"tokens": torch.tensor(b, device=dev)})
                    ["loss"]) for b in host_batches]
    del params, opt
    empty_cache(dev)
    return losses


def runtime_data(dev, cfg, train_out=None) -> dict:
    """Train from a shuffled Dataset on the runtime phase's cluster (see
    the module docstring).  Returns the step's numbers; the worker's flash
    launches under ``launches``."""
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.train import TorchTrainer
    on_card = dev.type == "cuda"
    L = cfg.num_layers if on_card else 0
    per_step = [2 * L, L, L, 0, 0, 0]
    B, S = RUNTIME_TRAIN_BATCH if on_card else (2, cfg.max_seq_len)
    rows = data_windows(cfg.vocab_size, B, S)
    t0 = time.perf_counter()
    ds = rd.from_numpy(rows, parallelism=RUNTIME_DATA_BLOCKS)
    ds = ds.random_shuffle(seed=0).materialize()
    shuffle_s = time.perf_counter() - t0
    check(ds.num_blocks() == RUNTIME_DATA_BLOCKS,
          f"the shuffle gave {ds.num_blocks()} blocks")
    host = [b["data"] for b in ds.iter_batches(batch_size=B)]
    check(len(host) == RUNTIME_DATA_BLOCKS and
          sorted(tokens_sha256(r) for b in host for r in b) ==
          sorted(map(tokens_sha256, rows)),
          "the shuffled Dataset's batches are not a permutation of its rows")
    free_card(on_card)
    apps_before = card_apps() if on_card else {}
    t0 = time.perf_counter()
    wall0 = time.time()
    result = TorchTrainer(
        data_worker_loop,
        train_loop_config={"fields": gpt_fields(cfg), "batch": B,
                           "device": None if on_card else "cpu"},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=on_card),
        datasets={"train": ds}).fit()
    fit_s = time.perf_counter() - t0
    free_card(on_card, apps_before=apps_before)
    hist = result.metrics_history
    steps = [r for r in hist if "step" in r]
    [done] = [r for r in hist if r.get("done")]
    check([r["step"] for r in steps] == list(range(1, len(host) + 1)),
          f"the worker took steps {[r['step'] for r in steps]}, not one "
          f"for each of the {len(host)} batches")
    check([r["sha256"] for r in steps] == [tokens_sha256(b) for b in host],
          "the worker's batches differ from the driver's iter_batches")
    if on_card:
        check(steps[0]["cuda_visible_devices"] == "0",
              f"the worker sees {steps[0]['cuda_visible_devices']!r}")
    n = list(done["launches"])
    check(n == [len(steps) * k for k in per_step],
          f"the worker launched {n} in {len(steps)} steps, expected "
          f"{per_step} a step")
    pinned = 2 if on_card else 0
    check(done["h2d_bytes"] == rows.nbytes and
          done["pinned_allocs"] == pinned,
          f"the ingest copied {done['h2d_bytes']} bytes of {rows.nbytes} "
          f"through {done['pinned_allocs']} pinned buffers (expected "
          f"{pinned})")
    losses = [r["loss"] for r in steps]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    want = in_process_data_losses(dev, cfg, host)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    check(rel <= DATA_LOSS_RTOL, f"the trainer's losses {losses} differ "
          f"from the in-process run's {want} by {rel} (rtol "
          f"{DATA_LOSS_RTOL})")
    waits = [r["wait_ms"] for r in steps]
    copy_ms = done["copy_ms"]
    timed = [r["step_ms"] for r in steps[1:]]
    out = {"rows": list(rows.shape), "blocks": RUNTIME_DATA_BLOCKS,
           "batch": [B, S], "steps": len(steps), "shuffle_s": shuffle_s,
           "fit_s": fit_s,
           "cold_start_s": steps[0]["wall_ready"] - wall0,
           "ms_per_step": statistics.median(timed), "step_ms": timed,
           "runtime_train_write_free_step_ms":
           (train_out or {}).get("write_free_step_ms"),
           "ingest_wait_ms_median": statistics.median(waits[1:]),
           "ingest_wait_ms_max": max(waits[1:]),
           "ingest_wait_ms_first": waits[0],
           "ingest_submit_ms_median": statistics.median(done["submit_ms"]),
           "h2d_bytes": done["h2d_bytes"], "copy_ms": copy_ms,
           "h2d_GBps": (done["h2d_bytes"] / (sum(copy_ms) / 1e3) / 1e9
                        if sum(copy_ms) else None),
           "pinned_allocs": done["pinned_allocs"],
           "losses": losses, "in_process_losses": want,
           "loss_max_rel_diff": rel, "loss_rtol": DATA_LOSS_RTOL,
           "bit_identical": losses == want, "launches": tuple(n)}
    return out


# ------------------------------------------------------------- runtime_tune

# The sweep: three learning rates in this grid order, one trial at a time
# (the node's one card), ASHA with rungs at steps 2 and 4 and max_t 8; one
# step is one training_iteration.  The order puts first the rate whose
# loss is lowest at step 2 (3e-4 for GPT-2-small in process on an H100;
# at 1e-3 the loss rises from step 2 on), so that ASHA stops the others
# at the first rung.
TUNE_LRS = (3e-4, 1e-3, 3e-5)
TUNE_MAX_T = 8
TUNE_GRACE = 2
TUNE_RF = 2


def tune_worker_loop(config):
    """The runtime_tune step's train_loop_per_worker: ``train_worker_loop``'s
    model and batches at ``config["lr"]``, one report a step.  It never
    reports ``done`` (the runner would read that as the trial's end); the
    report of step ``config["steps"]`` (ASHA's max_t, where it stops the
    trial) carries the params' sha256 and a checkpoint of them, copied to
    the host (the trial actor holds no card)."""
    import os
    wall0 = time.time()
    import torch

    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.air import Checkpoint, session
    from ray_tpu_torch.models import GPTConfig
    from ray_tpu_torch.train._internal import checkpoint_store as cs
    dev = resolve_device(config["device"])
    fields = config["fields"]
    cfg = GPTConfig(**{**fields, "dtype": getattr(torch, fields["dtype"])})
    fam = family(cfg)
    params, opt = fam.train_state(SEED, cfg, learning_rate=config["lr"],
                                  weight_decay=1e-4, device=dev)
    step_fn = fam.train_step(cfg, opt)
    sync(dev)
    start_info = {"wall_loop_start": wall0, "wall_ready": time.time(),
                  "pid": os.getpid(),
                  "cuda_visible_devices": os.environ.get(
                      "CUDA_VISIBLE_DEVICES")}
    B, S = config["batch"]
    reset_launch_counts()
    for step in range(config["steps"]):
        tokens = train_tokens(cfg.vocab_size, step, B, S).to(dev)
        t0 = time.perf_counter()
        loss = float(step_fn(params, {"tokens": tokens})["loss"])
        rec = {"step": step + 1, "loss": loss,
               "step_ms": (time.perf_counter() - t0) * 1e3,
               "wall": time.time(), "launches": launch_counts()}
        if step == 0:
            rec.update(start_info)
        ckpt = None
        if step + 1 == config["steps"]:
            t0 = time.perf_counter()
            host = cs.snapshot_to_host({"params": params})
            t1 = time.perf_counter()
            rec["params_sha256"] = params_sha256(host["params"])
            rec.update(snapshot_s=t1 - t0,
                       sha256_s=time.perf_counter() - t1,
                       wall_report=time.time())
            ckpt = Checkpoint.from_pytree(host)
        session.report(rec, checkpoint=ckpt)


def in_process_tune(dev, cfg, lr, B, S) -> dict:
    """``tune_worker_loop``'s steps at ``lr`` in this process: each step's
    loss and the params' sha256 after TUNE_MAX_T steps."""
    fam = family(cfg)
    params, opt = fam.train_state(SEED, cfg, learning_rate=lr,
                                  weight_decay=1e-4, device=dev)
    step_fn = fam.train_step(cfg, opt)
    losses = [float(step_fn(params, {"tokens": train_tokens(
        cfg.vocab_size, step, B, S).to(dev)})["loss"])
        for step in range(TUNE_MAX_T)]
    out = {"losses": losses, "params_sha256": params_sha256(params)}
    del params, opt
    empty_cache(dev)
    return out


def asha_replay(losses_by_lr, lrs=TUNE_LRS) -> dict:
    """The iteration at which a fresh ASHAScheduler (the sweep's settings)
    stops each trial, fed each rate's losses in grid order, one trial
    after the other as the runner runs them."""
    import types

    from ray_tpu_torch.tune.schedulers import ASHAScheduler
    sched = ASHAScheduler(max_t=TUNE_MAX_T, grace_period=TUNE_GRACE,
                          reduction_factor=TUNE_RF)
    sched.set_search_properties("loss", "min")
    stops = {}
    for i, lr in enumerate(lrs):
        trial = types.SimpleNamespace(trial_id=f"{i:05d}", scratch={})
        for it, loss in enumerate(losses_by_lr[lr], start=1):
            if sched.on_trial_result(None, trial, {
                    "loss": loss, "training_iteration": it}) == "STOP":
                stops[lr] = it
                break
    return stops


# A stopped trial's card memory is back when the card holds at most this
# much more than before the sweep (a worker's context alone is ~500 MiB).
CARD_MIB_SLACK = 256


@contextlib.contextmanager
def card_holders():
    """Samples the runtime's actor table every 0.25 s; yields a record
    whose ``max`` is the most live actors holding the card at once."""
    import threading

    from ray_tpu_torch.util import state
    rec = {"max": 0}
    done = threading.Event()

    def sample():
        while not done.wait(0.25):
            rec["max"] = max(rec["max"], len(
                [a for a in state.list_actors() if a["state"] == "ALIVE"
                 and (a.get("resources") or {}).get("GPU")]))

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield rec
    finally:
        done.set()
        thread.join(timeout=30)


@contextlib.contextmanager
def runner_probes(on_card, mib_before):
    """Time the trial runner's trial starts, checkpoint saves and stops
    in this process, and, after each stop, wait for the card to come back:
    the GPU resource (free_card) and the card's memory.used within
    CARD_MIB_SLACK of ``mib_before``.  ``card_holders`` counts the live
    actors holding the card meanwhile (nvidia-smi there lists every
    process on the card as pid 1, so it cannot tell them apart).  Yields
    the record."""
    from ray_tpu_torch.tune.execution.trial_runner import TrialRunner
    rec = {"starts": {}, "stops": {}, "saves": [], "gpu_actors_max": 0}
    orig = (TrialRunner._start_trial, TrialRunner._checkpoint_trial,
            TrialRunner._stop_actor)

    def start_trial(runner, trial, restore_from=None):
        rec["starts"][trial.trial_id] = time.time()
        orig[0](runner, trial, restore_from)

    def checkpoint_trial(runner, trial):
        wall = time.time()
        t0 = time.perf_counter()
        orig[1](runner, trial)
        secs = time.perf_counter() - t0
        state_ = (trial.checkpoint.to_dict().get("trainable_state") or {}
                  if trial.checkpoint is not None else {})
        fn_ckpt = state_.get("fn_checkpoint") or {}
        tree = fn_ckpt.get("__pytree__") or {}
        rec["saves"].append({
            "trial": trial.trial_id, "s": secs, "wall": wall,
            "bytes": sum(leaf.numel() * leaf.element_size()
                         for _, leaf in named_leaves(tree))})

    def stop_actor(runner, trial):
        t0 = time.time()
        orig[2](runner, trial)
        t1 = time.time()
        free_card(on_card)
        mib = None
        if on_card:
            deadline = time.monotonic() + 60
            while (mib := card_used_mib()) > mib_before + CARD_MIB_SLACK:
                check(time.monotonic() < deadline, f"the card holds {mib} "
                      f"MiB after trial {trial.trial_id}'s stop, "
                      f"{mib_before} before the sweep")
                time.sleep(0.2)
        rec["stops"][trial.trial_id] = {"start": t0, "end": t1,
                                        "card_free": time.time(),
                                        "card_mib": mib}

    TrialRunner._start_trial = start_trial
    TrialRunner._checkpoint_trial = checkpoint_trial
    TrialRunner._stop_actor = stop_actor
    try:
        with card_holders() as holders:
            yield rec
    finally:
        (TrialRunner._start_trial, TrialRunner._checkpoint_trial,
         TrialRunner._stop_actor) = orig
        rec["gpu_actors_max"] = holders["max"]


def runtime_tune(dev, cfg, train_out=None, lrs=TUNE_LRS) -> dict:
    """Tune a TorchTrainer on the runtime phase's cluster (see the module
    docstring), over the rates ``lrs`` in grid order.  Returns the step's
    numbers; the trials' flash launches (each trial's count at its last
    processed report) under ``launches``."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.air import Checkpoint, ScalingConfig
    from ray_tpu_torch.train import TorchTrainer
    from ray_tpu_torch.tune import TuneConfig, Tuner
    from ray_tpu_torch.tune.schedulers import ASHAScheduler
    on_card = dev.type == "cuda"
    L = cfg.num_layers if on_card else 0
    per_step = [2 * L, L, L, 0, 0, 0]
    B, S = RUNTIME_TRAIN_BATCH if on_card else (2, cfg.max_seq_len)
    t0 = time.perf_counter()
    want = {lr: in_process_tune(dev, cfg, lr, B, S) for lr in lrs}
    in_process_s = time.perf_counter() - t0
    expected = asha_replay({lr: w["losses"] for lr, w in want.items()},
                           lrs)
    check(sorted(expected) == sorted(lrs), f"the replay {expected}")
    check(any(it < TUNE_MAX_T for it in expected.values()),
          f"ASHA stops no trial before max_t on the in-process losses "
          f"{want}; reorder TUNE_LRS")
    # The best result: the lowest last loss among the trials.
    best_lr = min(lrs, key=lambda lr: want[lr]["losses"][
        expected[lr] - 1])
    check(expected[best_lr] == TUNE_MAX_T, f"the best rate {best_lr} "
          f"stops at {expected[best_lr]}, before its checkpoint")
    free_card(on_card)
    mib_before = card_used_mib() if on_card else 0
    trainer = TorchTrainer(
        tune_worker_loop,
        train_loop_config={"fields": gpt_fields(cfg), "batch": [B, S],
                           "steps": TUNE_MAX_T,
                           "device": None if on_card else "cpu"},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=on_card))
    t0 = time.perf_counter()
    with runner_probes(on_card, mib_before) as probes:
        grid = Tuner(
            trainer,
            param_space={"train_loop_config": {
                "lr": tune.grid_search(list(lrs))}},
            tune_config=TuneConfig(
                metric="loss", mode="min", max_concurrent_trials=1,
                scheduler=ASHAScheduler(max_t=TUNE_MAX_T,
                                        grace_period=TUNE_GRACE,
                                        reduction_factor=TUNE_RF))).fit()
    fit_s = time.perf_counter() - t0
    check(not grid.errors, f"trials failed: {grid.errors}")
    check(len(grid) == len(lrs), f"{len(grid)} trials")
    free_card(on_card)
    trials, total = [], [0] * 6
    for i, (lr, r) in enumerate(zip(lrs, grid)):
        tid = f"{i:05d}"
        check(r.metrics["config"]["train_loop_config"]["lr"] == lr,
              f"trial {tid} ran {r.metrics['config']}, not lr {lr}")
        hist = r.metrics_history
        losses = [m["loss"] for m in hist]
        check([m["step"] for m in hist] == list(range(1, len(hist) + 1)),
              f"trial {tid} reported steps {[m['step'] for m in hist]}")
        check(losses == want[lr]["losses"][:len(losses)],
              f"trial {tid} (lr {lr}) losses {losses} differ from the "
              f"in-process run's {want[lr]['losses']}")
        check(len(hist) == expected[lr], f"the runner stopped trial {tid} "
              f"(lr {lr}) at {len(hist)}; the replay at {expected[lr]}")
        n = list(hist[-1]["launches"])
        check(n == [len(hist) * k for k in per_step],
              f"trial {tid} launched {n} in {len(hist)} steps, expected "
              f"{per_step} a step")
        total = [a + b for a, b in zip(total, n)]
        first = hist[0]
        if on_card:
            check(first["cuda_visible_devices"] == "0",
                  f"trial {tid}'s worker sees "
                  f"{first['cuda_visible_devices']!r}")
        start = probes["starts"][tid]
        stop = probes["stops"][tid]
        trials.append({
            "trial": tid, "lr": lr, "iterations": len(hist),
            "losses": losses, "cold_start_s": first["wall_ready"] - start,
            "to_loop_start_s": first["wall_loop_start"] - start,
            "ms_per_step": statistics.median(
                [m["step_ms"] for m in hist[1:]]) if len(hist) > 1
            else None,
            "step_ms": [m["step_ms"] for m in hist],
            "stop_s": stop["end"] - stop["start"],
            "stop_to_card_free_s": stop["card_free"] - stop["start"],
            "last_step_to_stop_s": stop["start"] - hist[-1]["wall"]})
        last = hist[-1]
        if "wall_report" in last:
            # The last step's tail: the host snapshot and the hash on the
            # worker, the report's trip through the trial actor to the
            # runner, the runner's saves, then the stop.
            saves = [x for x in probes["saves"] if x["trial"] == tid]
            trials[-1].update(
                snapshot_s=last["snapshot_s"], sha256_s=last["sha256_s"],
                report_to_runner_s=saves[0]["wall"] - last["wall_report"],
                saves_s=[x["s"] for x in saves])
    check(probes["gpu_actors_max"] <= (1 if on_card else 0),
          f"{probes['gpu_actors_max']} live actors held the card at once")
    gaps = []
    for prev, nxt in zip(trials, trials[1:]):
        stop = probes["stops"][prev["trial"]]
        start = probes["starts"][nxt["trial"]]
        first = grid[int(nxt["trial"])].metrics_history[0]
        gaps.append({"after": prev["trial"],
                     "stop_to_loop_start_s": first["wall_loop_start"] -
                     stop["start"],
                     "stop_s": stop["end"] - stop["start"],
                     "card_free_s": stop["card_free"] - stop["start"],
                     "card_free_to_trial_start_s": start - stop["card_free"],
                     "trial_start_to_loop_start_s":
                     first["wall_loop_start"] - start})
    best = grid.get_best_result()
    best_cfg_lr = best.metrics["config"]["train_loop_config"]["lr"]
    check(best_cfg_lr == best_lr, f"the best result is lr {best_cfg_lr}, "
          f"the in-process losses make {best_lr} best")
    check(best.metrics.get("params_sha256") ==
          want[best_lr]["params_sha256"],
          "the best trial's reported params differ from the in-process "
          "run's")
    t0 = time.perf_counter()
    state = best.checkpoint.to_dict()["trainable_state"]
    tree = Checkpoint.from_dict(state["fn_checkpoint"]).to_pytree()
    sha = params_sha256(tree["params"])
    read_s = time.perf_counter() - t0
    check(sha == want[best_lr]["params_sha256"],
          "the best trial's checkpoint, read on the driver, hashes to "
          f"{sha}, not the in-process params' "
          f"{want[best_lr]['params_sha256']}")
    # Only trials that reached max_t hold a checkpoint to save.
    full = {f"{i:05d}" for i, lr in enumerate(lrs)
            if expected[lr] == TUNE_MAX_T}
    check({s["trial"] for s in probes["saves"] if s["bytes"]} == full,
          f"the checkpoint saves {probes['saves']}")
    saves = [s for s in probes["saves"]
             if s["trial"] == f"{lrs.index(best_lr):05d}"]
    steps_ms = [x for t in trials for x in t["step_ms"][1:]]
    return {"lrs": list(lrs), "max_t": TUNE_MAX_T,
            "grace_period": TUNE_GRACE, "reduction_factor": TUNE_RF,
            "batch": [B, S], "fit_s": fit_s, "in_process_s": in_process_s,
            "stops": {str(lr): expected[lr] for lr in lrs},
            "best_lr": best_lr, "best_params_sha256": sha,
            "trials": trials, "gaps": gaps,
            "ms_per_step": statistics.median(steps_ms) if steps_ms
            else None,
            "runtime_train_write_free_step_ms":
            (train_out or {}).get("write_free_step_ms"),
            "saves": probes["saves"], "best_save_bytes": saves[-1]["bytes"],
            "best_save_s": [s["s"] for s in saves],
            "best_read_and_hash_s": read_s,
            "gpu_actors_max": probes["gpu_actors_max"],
            "card_mib_before": mib_before,
            "card_mib_after_stops": [probes["stops"][t["trial"]]["card_mib"]
                                     for t in trials],
            "launches": tuple(total)}


# ------------------------------------------------------------ runtime_rllib

RLLIB_PPO_ITERS = 25
RLLIB_LOSS_RTOL = 1e-5
RLLIB_GRAD_RTOL = 1e-4


def weights_sha256(weights) -> str:
    """``params_sha256`` of a policy's numpy weight tree."""
    import torch

    from ray_tpu_torch.rllib.policy import tree_map
    return params_sha256(tree_map(torch.from_numpy, weights))


def _worker_card_and_hash(worker):
    """On a rollout worker: its card mask, its policy's device and the
    sha256 of its weights."""
    return (os.environ.get("CUDA_VISIBLE_DEVICES"), str(worker.policy.device),
            weights_sha256(worker.get_weights()))


def grads_agree(card, cpu, rtol=RLLIB_GRAD_RTOL) -> float:
    """The largest leaf error over the leaf's max |g| (checked <= rtol)."""
    import numpy as np

    from ray_tpu_torch.rllib.policy import tree_leaves
    worst = 0.0
    for a, b in zip(tree_leaves(card), tree_leaves(cpu)):
        worst = max(worst, float(np.abs(a - b).max()) /
                    max(float(np.abs(b).max()), 1e-30))
    check(worst <= rtol, f"a grad leaf differs by {worst} of its max |g| "
          f"between the card and the CPU (limit {rtol})")
    return worst


def workers_gone(handles, timeout=30):
    from ray_tpu_torch.util import state
    ids = {h._actor_id_hex for h in handles}
    deadline = time.monotonic() + timeout
    while True:
        alive = [a["actor_id"] for a in state.list_actors()
                 if a["actor_id"] in ids and a["state"] != "DEAD"]
        if not alive:
            return
        check(time.monotonic() < deadline,
              f"rollout workers {alive} outlive their algorithm's stop")
        time.sleep(0.2)


def _timed(rec, key, fn):
    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        rec.setdefault(key, []).append(time.perf_counter() - t0)
        return out
    return wrapped


def rllib_ppo(dev, iters=RLLIB_PPO_ITERS) -> dict:
    import torch

    from ray_tpu_torch.rllib import PPOConfig, PPOPolicy
    on_card = dev.type == "cuda"
    config = (PPOConfig().environment("CartPole-v1")
              .rollouts(num_rollout_workers=2, num_envs_per_worker=8,
                        rollout_fragment_length=64)
              .training(lr=5e-4, num_sgd_iter=6, sgd_minibatch_size=256,
                        entropy_coeff=0.005)
              .resources(device=None if on_card else "cpu")
              .debugging(seed=0))
    t0 = time.perf_counter()
    algo = config.build()
    algo.workers.ready()
    cold_s = time.perf_counter() - t0
    policy = algo.get_policy()
    check(policy.device.type == dev.type, f"the learner is on "
          f"{policy.device}, not {dev}")
    rec, first = {}, {}
    learn = policy.learn_on_batch

    def learn_timed(batch):
        if not first:
            first.update(weights=policy.get_weights(), batch=batch,
                         card=policy.first_minibatch(batch))
        sync(dev)
        t = time.perf_counter()
        out = learn(batch)            # its stats' copy to the host syncs
        rec.setdefault("learn", []).append(time.perf_counter() - t)
        return out

    policy.learn_on_batch = learn_timed
    ws = algo.workers
    ws.synchronous_sample = _timed(rec, "sample", ws.synchronous_sample)
    ws.sync_weights = _timed(rec, "sync", ws.sync_weights)
    rewards, losses = [], []
    with card_holders() as holders:
        t0 = time.perf_counter()
        for _ in range(iters):
            r = algo.train()
            rewards.append(r.get("episode_reward_mean"))
            losses.append(r["learner_total_loss"])
        train_s = time.perf_counter() - t0
        ws.sync_weights()
        seen = ws.foreach_worker(_worker_card_and_hash)[1:]
    check(all(math.isfinite(x) for x in losses), f"PPO losses {losses}")
    got = [x for x in rewards if x is not None]
    check(got and got[-1] > got[0] + 10, f"PPO's episode_reward_mean went "
          f"from {got[:1]} to {got[-1:]}: not more than 10 up")
    want = weights_sha256(policy.get_weights())
    check([s[2] for s in seen] == [want] * 2,
          f"the workers' weights {[s[2] for s in seen]} are not the "
          f"learner's {want}")
    check([s[:2] for s in seen] == [("", "cpu")] * 2,
          f"the rollout workers see (card mask, device) {seen}")
    check(holders["max"] == 0, f"{holders['max']} live actors held the "
          f"card during PPO")
    cpu = PPOPolicy(4, _space(algo),
                    dict(algo.config, device="cpu"), seed=policy.seed)
    cpu.set_weights(first["weights"])
    stats_cpu, grads_cpu = cpu.first_minibatch(first["batch"])
    stats_card, grads_card = first["card"]
    loss_err = abs(stats_card["total_loss"] - stats_cpu["total_loss"]) / \
        abs(stats_cpu["total_loss"])
    check(loss_err <= RLLIB_LOSS_RTOL, f"PPO's first-minibatch loss "
          f"{stats_card['total_loss']} on the card, {stats_cpu['total_loss']}"
          f" on the CPU")
    grad_err = grads_agree(grads_card, grads_cpu)
    cpu_ms = []
    for _ in range(3):
        t = time.perf_counter()
        cpu.learn_on_batch(first["batch"])
        cpu_ms.append((time.perf_counter() - t) * 1e3)
    handles = list(ws.remote_workers)
    algo.stop()
    workers_gone(handles)
    learn_ms = [x * 1e3 for x in rec["learn"]]
    return {"iterations": iters, "workers": 2, "cold_start_s": cold_s,
            "train_s": train_s, "rewards": rewards,
            "reward_first": got[0], "reward_last": got[-1],
            "losses": losses, "batch_rows": int(first["batch"].count),
            "updates_per_iteration": 6 * (first["batch"].count // 256),
            "sample_s": rec["sample"][:iters],
            "sample_s_median": statistics.median(rec["sample"][:iters]),
            "sync_ms_median": statistics.median(
                [x * 1e3 for x in rec["sync"]]),
            "learner_ms": learn_ms,
            "learner_ms_median": statistics.median(learn_ms[1:]),
            "learner_cpu_ms": cpu_ms,
            "learner_cpu_ms_median": statistics.median(cpu_ms),
            "first_minibatch_loss": [stats_card["total_loss"],
                                     stats_cpu["total_loss"]],
            "first_loss_rel_err": loss_err, "first_grad_rel_err": grad_err,
            "worker_weights_sha256": want, "gpu_actors_max": holders["max"]}


def _space(algo):
    return algo.workers.local_worker.env.action_space


def rllib_impala(dev) -> dict:
    from ray_tpu_torch.rllib import ImpalaConfig, ImpalaPolicy
    on_card = dev.type == "cuda"
    config = (ImpalaConfig().environment("CartPole-v1")
              .rollouts(num_rollout_workers=1, num_envs_per_worker=4,
                        rollout_fragment_length=16)
              .training(num_batches_per_step=2)
              .resources(device=None if on_card else "cpu")
              .debugging(seed=0))
    t0 = time.perf_counter()
    algo = config.build()
    cold_s = time.perf_counter() - t0
    policy = algo.get_policy()
    first, rec = {}, {}
    learn = policy.learn_on_batch

    def learn_first(batch):
        if not first:
            first.update(weights=policy.get_weights(),
                         devices={str(v.device) for v in batch.values()},
                         batch={k: v.cpu() for k, v in batch.items()},
                         card=policy.loss_and_grads(batch))
        sync(dev)
        t = time.perf_counter()
        out = learn(batch)
        rec.setdefault("learn", []).append(time.perf_counter() - t)
        return out

    policy.learn_on_batch = learn_first
    with card_holders() as holders:
        r1 = algo.step()
        r2 = algo.step()
    check(r2["num_updates"] > r1["num_updates"] >= 2,
          f"IMPALA's num_updates {r1['num_updates']}, {r2['num_updates']}")
    losses = [r1["learner_total_loss"], r2["learner_total_loss"]]
    check(all(math.isfinite(x) for x in losses), f"IMPALA losses {losses}")
    check(first["devices"] == {str(policy.device)}, f"the loader put the "
          f"batch on {first['devices']}, not {policy.device}")
    check(holders["max"] == 0, f"{holders['max']} live actors held the "
          f"card during IMPALA")
    cpu = ImpalaPolicy(4, _space(algo), dict(algo.config, device="cpu"),
                       seed=policy.seed)
    cpu.set_weights(first["weights"])
    stats_cpu, grads_cpu = cpu.loss_and_grads(first["batch"])
    stats_card, grads_card = first["card"]
    loss_err = abs(stats_card["total_loss"] - stats_cpu["total_loss"]) / \
        abs(stats_cpu["total_loss"])
    check(loss_err <= RLLIB_LOSS_RTOL, f"IMPALA's first loss "
          f"{stats_card['total_loss']} on the card, "
          f"{stats_cpu['total_loss']} on the CPU")
    grad_err = grads_agree(grads_card, grads_cpu)
    handles = list(algo.workers.remote_workers)
    loader_wait = list(algo.loader_wait_ms)
    algo.stop()
    workers_gone(handles)
    return {"steps": 2, "num_updates": [r1["num_updates"],
                                        r2["num_updates"]],
            "losses": losses, "cold_start_s": cold_s,
            "loader_wait_ms": loader_wait,
            "learner_ms": [x * 1e3 for x in rec["learn"]],
            "first_loss_rel_err": loss_err, "first_grad_rel_err": grad_err,
            "batch_device": sorted(first["devices"]),
            "gpu_actors_max": holders["max"]}


RLLIB_APEX_ITERS = 10
RLLIB_APEX_UPDATES = 16
RLLIB_SAC_STEPS = 4
RLLIB_QMIX_STEPS = 10


def _stat_err(card, cpu, floor=0.0) -> float:
    """|card - cpu| over max(|cpu|, floor)."""
    return abs(card - cpu) / max(abs(cpu), floor, 1e-30)


def rllib_apex(dev, iters=RLLIB_APEX_ITERS) -> dict:
    """Ape-X DQN at tests/test_rllib_apex.py:14-19's config."""
    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import ApexDQNConfig, DQNPolicy
    on_card = dev.type == "cuda"
    config = (ApexDQNConfig().environment("CartPole-v1")
              .rollouts(num_rollout_workers=3, num_envs_per_worker=4,
                        rollout_fragment_length=4)
              .training(lr=1e-3, learning_starts=500,
                        num_train_iters=RLLIB_APEX_UPDATES,
                        target_network_update_freq=60, broadcast_interval=2)
              .resources(device=None if on_card else "cpu")
              .debugging(seed=0))
    t0 = time.perf_counter()
    algo = config.build()
    rt.get([sh.size.remote() for sh in algo.replay_shards], timeout=120)
    cold_s = time.perf_counter() - t0
    policy = algo.get_policy()
    check(policy.device.type == dev.type, f"Ape-X's learner is on "
          f"{policy.device}, not {dev}")
    eps = algo._worker_eps
    check(len(eps) == 3 and abs(eps[0] - 0.4) <= 1e-6 * 0.4
          and eps[-1] < 0.01 and all(a > b for a, b in zip(eps, eps[1:])),
          f"Ape-X's epsilon ladder {eps}")
    rec, first = {}, {}
    learn = policy.learn_on_batch

    def learn_timed(batch):
        if not first:
            first.update(weights=policy.get_weights(), batch=batch,
                         card=policy.loss_and_grads(batch))
        sync(dev)
        t = time.perf_counter()
        out = learn(batch)            # its host copy of the TD errors syncs
        rec.setdefault("learn", []).append(time.perf_counter() - t)
        return out

    policy.learn_on_batch = learn_timed
    algo._harvest = _timed(rec, "harvest", algo._harvest)
    updates, losses, rewards, harvest_ms = [], [], [], []
    with card_holders() as holders:
        t0 = time.perf_counter()
        for _ in range(iters):
            n = len(rec.get("harvest", []))
            r = algo.train()
            harvest_ms.append(sum(rec["harvest"][n:]) * 1e3)
            updates.append(r["num_updates"])
            losses.append(r["learner_loss"])
            rewards.append(r.get("episode_reward_mean"))
        train_s = time.perf_counter() - t0
        sizes = rt.get([sh.size.remote() for sh in algo.replay_shards],
                       timeout=60)
        shard_cards = rt.get([sh.visible_cards.remote()
                              for sh in algo.replay_shards], timeout=60)
        algo.workers.sync_weights()
        seen = algo.workers.foreach_worker(_worker_card_and_hash)[1:]
    check(updates == [RLLIB_APEX_UPDATES * (i + 1) for i in range(iters)],
          f"Ape-X's num_updates {updates}")
    check(all(math.isfinite(x) for x in losses), f"Ape-X losses {losses}")
    check(all(x > 0 for x in sizes), f"Ape-X's shard sizes {sizes}")
    want = weights_sha256(policy.get_weights())
    check([x[2] for x in seen] == [want] * 3, f"the workers' weights "
          f"{[x[2] for x in seen]} are not the learner's {want}")
    check([x[:2] for x in seen] == [("", "cpu")] * 3,
          f"Ape-X's workers see (card mask, device) {seen}")
    check(shard_cards == ["", ""], f"the replay shards see cards "
          f"{shard_cards}")
    check(holders["max"] == 0, f"{holders['max']} live actors held the "
          f"card during Ape-X")
    cpu = DQNPolicy(4, _space(algo), dict(algo.config, device="cpu"),
                    seed=policy.seed)
    cpu.set_weights(first["weights"])
    cpu.target_params = cpu.params     # the target at the first update
    loss_cpu, grads_cpu = cpu.loss_and_grads(first["batch"])
    loss_card, grads_card = first["card"]
    loss_err = _stat_err(loss_card, loss_cpu)
    check(loss_err <= RLLIB_LOSS_RTOL, f"Ape-X's first loss {loss_card} on "
          f"the card, {loss_cpu} on the CPU")
    grad_err = grads_agree(grads_card, grads_cpu)
    cpu_ms = []
    for _ in range(5):
        t = time.perf_counter()
        cpu.learn_on_batch(first["batch"])
        cpu_ms.append((time.perf_counter() - t) * 1e3)
    handles = list(algo.workers.remote_workers) + list(algo.replay_shards)
    sample_ms = list(algo.sample_ms)
    algo.stop()
    workers_gone(handles)
    learn_ms = [x * 1e3 for x in rec["learn"]]
    return {"iterations": iters, "workers": 3, "shards": 2,
            "cold_start_s": cold_s, "train_s": train_s,
            "worker_epsilons": eps, "num_updates": updates,
            "losses": losses, "rewards": rewards, "shard_sizes": sizes,
            "learner_ms_median": statistics.median(learn_ms[1:]),
            "learner_ms_p90": float(np.percentile(learn_ms[1:], 90)),
            "learner_cpu_ms": cpu_ms,
            "learner_cpu_ms_median": statistics.median(cpu_ms),
            "shard_sample_ms_median": statistics.median(sample_ms),
            "shard_sample_ms_p90": float(np.percentile(sample_ms, 90)),
            "shard_samples": len(sample_ms),
            "harvest_ms_per_train": harvest_ms,
            "train_ms_per_call": train_s * 1e3 / iters,
            "first_loss": [loss_card, loss_cpu],
            "first_loss_rel_err": loss_err, "first_grad_rel_err": grad_err,
            "worker_weights_sha256": want, "gpu_actors_max": holders["max"],
            "torch_threads": torch.get_num_threads()}


def rllib_sac(dev, steps=RLLIB_SAC_STEPS) -> dict:
    """SAC at tests/test_rllib_dqn_impala.py:178-184's config (the local
    worker samples: no actor)."""
    from ray_tpu_torch.rllib import SACConfig, SACPolicy, weights_from_jax
    from ray_tpu_torch.rllib.policy import tree_to_numpy
    on_card = dev.type == "cuda"
    config = (SACConfig().environment("Pendulum-v1")
              .rollouts(num_rollout_workers=0, num_envs_per_worker=4)
              .training(learning_starts=64, train_batch_size=32,
                        num_train_iters=2, rollout_fragment_length=8)
              .resources(device=None if on_card else "cpu")
              .debugging(seed=0))
    algo = config.build()
    policy = algo.get_policy()
    check(policy.device.type == dev.type, f"SAC's learner is on "
          f"{policy.device}, not {dev}")
    rec, first = {}, {}
    learn = policy.learn_on_batch

    def learn_timed(batch):
        if not first:
            noise = policy.draw_noise(batch.count)
            first.update(weights=policy.get_weights(), batch=batch,
                         target=tree_to_numpy(policy.target), noise=noise)
            stats, grads = policy.learn_with_grads(batch, noise)
            first["card"] = (stats, grads)
            return stats
        sync(dev)
        t = time.perf_counter()
        out = learn(batch)            # its stats' copy to the host syncs
        rec.setdefault("learn", []).append(time.perf_counter() - t)
        return out

    policy.learn_on_batch = learn_timed
    results = [algo.step() for _ in range(steps)]
    crit = [r["critic_loss"] for r in results if "critic_loss" in r]
    check(len(crit) >= 2 and all(math.isfinite(x) for x in crit),
          f"SAC's critic losses {crit}")
    cpu = SACPolicy(3, _space(algo), dict(algo.config, device="cpu"),
                    seed=policy.seed)
    cpu.set_weights(first["weights"])
    cpu.target = weights_from_jax(first["target"], "cpu")
    stats_cpu, grads_cpu = cpu.learn_with_grads(first["batch"],
                                                first["noise"])
    stats_card, grads_card = first["card"]
    # The critic loss is a mean of squares (plain relative); the actor
    # loss, alpha and the entropy are means of terms of size ~1 that
    # nearly cancel (held to 1e-5 of max(|x|, 1)).
    errs = {k: _stat_err(stats_card[k], stats_cpu[k],
                         0.0 if k == "critic_loss" else 1.0)
            for k in stats_cpu}
    check(max(errs.values()) <= RLLIB_LOSS_RTOL, f"SAC's first update "
          f"{stats_card} on the card, {stats_cpu} on the CPU")
    grad_err = grads_agree(grads_card, grads_cpu)
    cpu_ms = []
    for _ in range(5):
        t = time.perf_counter()
        cpu.learn_on_batch(first["batch"])
        cpu_ms.append((time.perf_counter() - t) * 1e3)
    algo.stop()
    learn_ms = [x * 1e3 for x in rec["learn"]]
    return {"steps": steps, "critic_losses": crit,
            "learner_ms": learn_ms,
            "learner_ms_median": statistics.median(learn_ms),
            "learner_cpu_ms": cpu_ms,
            "learner_cpu_ms_median": statistics.median(cpu_ms),
            "first_stats": [stats_card, stats_cpu],
            "first_stat_rel_err": errs, "first_grad_rel_err": grad_err}


def rllib_qmix(dev, steps=RLLIB_QMIX_STEPS) -> dict:
    """QMIX at tests/test_rllib_qmix.py:18-22's config."""
    import numpy as np

    from ray_tpu_torch.rllib import QMIX, QMIXConfig, weights_from_jax
    from ray_tpu_torch.rllib.policy import tree_to_numpy
    on_card = dev.type == "cuda"
    config = (QMIXConfig().environment("TwoStepGame-v0")
              .training(mixer="qmix", epsilon_initial=1.0,
                        epsilon_final=1.0, lr=1e-3,
                        target_network_update_freq=50)
              .resources(device=None if on_card else "cpu")
              .debugging(seed=0))
    algo = config.build()
    check(algo.device.type == dev.type, f"QMIX runs on {algo.device}, not "
          f"{dev}")
    rec, first = {}, {}
    update, episode = algo._update, algo._run_episode

    def update_timed(batch):
        if not first:
            first.update(
                weights=algo.save_checkpoint(),
                targets=(tree_to_numpy(algo.t_q), tree_to_numpy(algo.t_m)),
                batch={k: v.cpu() for k, v in batch.items()},
                card=algo.loss_and_grads(batch))
        sync(dev)
        t = time.perf_counter()
        loss = update(batch)
        float(loss)
        rec.setdefault("update", []).append(time.perf_counter() - t)
        return loss

    def episode_timed():
        t = time.perf_counter()
        out = episode()
        rec.setdefault("episode", []).append(time.perf_counter() - t)
        return out

    algo._update, algo._run_episode = update_timed, episode_timed
    results = [algo.step() for _ in range(steps)]
    losses = [r["loss"] for r in results]
    # The first 3 steps fill the buffer to learning_starts (64 transitions,
    # 16 a step) and make no update: their loss is nan.
    check(all(math.isnan(x) for x in losses[:3])
          and all(math.isfinite(x) for x in losses[3:]),
          f"QMIX losses {losses}")
    check(len(rec["update"]) == 4 * (steps - 3), f"QMIX made "
          f"{len(rec['update'])} updates")
    greedy = algo.greedy_episode_reward()
    cpu = QMIX(config=dict(algo.config, device="cpu"))
    cpu.load_checkpoint(first["weights"])
    cpu.t_q = weights_from_jax(first["targets"][0], "cpu")
    cpu.t_m = weights_from_jax(first["targets"][1], "cpu")
    loss_cpu, grads_cpu = cpu.loss_and_grads(first["batch"])
    loss_card, grads_card = first["card"]
    loss_err = _stat_err(loss_card, loss_cpu)
    check(loss_err <= RLLIB_LOSS_RTOL, f"QMIX's first loss {loss_card} on "
          f"the card, {loss_cpu} on the CPU")
    grad_err = grads_agree(grads_card, grads_cpu)
    cpu_ms = []
    for _ in range(5):
        t = time.perf_counter()
        float(cpu._update(first["batch"]))
        cpu_ms.append((time.perf_counter() - t) * 1e3)
    algo.stop()
    update_ms = [x * 1e3 for x in rec["update"]]
    episode_ms = [x * 1e3 for x in rec["episode"]]
    return {"steps": steps,
            "losses": [None if math.isnan(x) else x for x in losses],
            "episode_reward_mean": results[-1]["episode_reward_mean"],
            "greedy_reward": greedy, "updates": len(update_ms),
            "update_ms_median": statistics.median(update_ms[1:]),
            "update_cpu_ms": cpu_ms,
            "update_cpu_ms_median": statistics.median(cpu_ms),
            "episodes": len(episode_ms),
            "episode_ms_median": statistics.median(episode_ms),
            "episode_ms_p90": float(np.percentile(episode_ms, 90)),
            "first_loss": [loss_card, loss_cpu],
            "first_loss_rel_err": loss_err, "first_grad_rel_err": grad_err}


def card_back(dev, alloc_before, mib_before, after: str) -> list:
    """Check that the card's allocated bytes and memory.used are back to
    the step's reading; returns [bytes, MiB]."""
    import gc

    import torch
    on_card = dev.type == "cuda"
    gc.collect()
    empty_cache(dev)
    alloc = torch.cuda.memory_allocated(dev) if on_card else 0
    mib = card_used_mib() if on_card else 0
    check(alloc <= alloc_before, f"the card holds {alloc} bytes of tensors "
          f"after {after}'s stop, {alloc_before} before the step")
    check(mib <= mib_before + CARD_MIB_SLACK, f"the card's memory.used is "
          f"{mib} MiB after {after}'s stop, {mib_before} before the step")
    return [alloc, mib]


def runtime_rllib(dev, ppo_iters=RLLIB_PPO_ITERS) -> dict:
    """PPO, IMPALA, Ape-X DQN, SAC and QMIX on the runtime phase's
    cluster (see the module docstring); returns the step's numbers."""
    import torch
    on_card = dev.type == "cuda"
    free_card(on_card)
    # cuBLAS and cuBLASLt keep a workspace per thread and stream in the
    # caching allocator for the life of the process (32 MiB and 1 MiB on
    # the card), and the autograd engine runs a card's backward on a
    # thread of its own: an addmm with a bias, forward and backward, takes
    # them before the reading.
    one = torch.ones((2, 2), device=dev, requires_grad=True)
    torch.addmm(one[0], one, one).sum().backward()
    del one
    empty_cache(dev)
    alloc_before = torch.cuda.memory_allocated(dev) if on_card else 0
    mib_before = card_used_mib() if on_card else 0
    out, back = {}, {}
    for name, fn in (("ppo", lambda: rllib_ppo(dev, ppo_iters)),
                     ("impala", lambda: rllib_impala(dev)),
                     ("apex", lambda: rllib_apex(dev)),
                     ("sac", lambda: rllib_sac(dev)),
                     ("qmix", lambda: rllib_qmix(dev))):
        t0 = time.perf_counter()
        out[name] = fn()
        out[name]["wall_s"] = time.perf_counter() - t0
        back[name] = card_back(dev, alloc_before, mib_before, name)
    free_card(on_card)
    return {**out, "alloc_bytes_before": alloc_before,
            "card_mib_before": mib_before, "after_stop": back}


# ---------------------------------------------------------- runtime_cluster

# The cluster layer's paths each run GPT-2-small's bf16 flash forward on
# [4, 1024] tokens in a num_gpus=1 actor; the autoscaler ends its idle GPU
# node after CLUSTER_IDLE_S.
CLUSTER_TOKENS = (4, 1024)
CLUSTER_IDLE_S = 10.0
ROOT = os.path.dirname(os.path.abspath(__file__))


def cluster_config():
    """GPT-2-small, bf16, flash: the configuration of every cluster path
    (the job's entrypoint and the client build it themselves)."""
    import torch
    from ray_tpu_torch.models import GPTConfig
    return dataclasses.replace(GPTConfig.gpt2_small(), dtype=torch.bfloat16,
                               attention="flash")


def cluster_tokens(cfg):
    """The paths' [4, 1024] tokens, from seed 0."""
    import torch
    gen = torch.Generator().manual_seed(SEED)
    return torch.randint(0, cfg.vocab_size, CLUSTER_TOKENS, generator=gen)


def cluster_inputs(cfg):
    """GPT-2-small's f32 params as numpy (as the runtime phase makes them)
    and the paths' tokens, from seed 0."""
    from ray_tpu_torch.models import gpt_init, params_to_numpy
    return (params_to_numpy(gpt_init(SEED, cfg, device="cpu")),
            cluster_tokens(cfg))


def drive_gpt_actor(actor, get, tokens) -> dict:
    """A GPTActor's first answer, one forward and its logits, through
    ``get`` (the runtime's or a client's); the logits by hash."""
    t0 = time.perf_counter()
    info = get(actor.info.remote())
    first_answer_s = time.perf_counter() - t0
    fwd = get(actor.forward.remote(tokens, timed=0))
    t0 = time.perf_counter()
    logits = get(actor.get_logits.remote())
    get_ms = (time.perf_counter() - t0) * 1e3
    return {"first_answer_s": first_answer_s,
            "actor_visible": info["cuda_visible_devices"],
            "actor_node_id": info["node_id"],
            "actor_import_torch_s": info["import_torch_s"],
            "actor_cuda_init_s": info["cuda_init_s"],
            "actor_params_s": info["params_s"],
            "launches": list(fwd["launches"]), "forward_ms": fwd["ms_total"],
            "logits_sha256": tensor_sha256(logits),
            "logits_device": logits.device.type,
            "logits_shape": list(logits.shape),
            "logits_dtype": str(logits.dtype).removeprefix("torch."),
            "get_logits_ms": get_ms}


class CardHolder:
    """A num_gpus=1 actor that holds 1 GiB of its card."""

    def hold(self, nbytes=1 << 30) -> float:
        import torch
        self.block = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
        torch.cuda.synchronize()
        return torch.cuda.memory_reserved() / 2**20


def cluster_job_main(hold: bool) -> int:
    """A job's entrypoint (runtime_cluster, path a).  It joins the cluster
    through RT_ADDRESS and must see no card itself; it then drives a
    GPTActor's forward and prints one CLUSTER_JOB line, or, with ``hold``,
    keeps a CardHolder until SIGTERM, which kills the holder (actors
    outlive their driver) and exits."""
    started = time.time()
    import signal

    import torch

    import ray_tpu_torch as rt
    rt.init()
    out = {"started_at": started,
           "cuda_available": torch.cuda.is_available(),
           "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}
    check(not out["cuda_available"],
          f"the job's entrypoint sees a card (CUDA_VISIBLE_DEVICES="
          f"{out['cuda_visible_devices']!r})")
    if hold:
        holder = rt.remote(CardHolder).options(num_gpus=1).remote()
        out["holder_reserved_mib"] = rt.get(holder.hold.remote(),
                                            timeout=600)

        def stop(*_):
            rt.kill(holder)
            print("CLUSTER_JOB_RELEASED", flush=True)
            sys.exit(0)

        signal.signal(signal.SIGTERM, stop)
        print("CLUSTER_JOB_HOLDING " + json.dumps(out), flush=True)
        while True:
            time.sleep(1)
    cfg = cluster_config()
    tree, tokens = cluster_inputs(cfg)
    actor = rt.remote(GPTActor).options(num_gpus=1).remote(
        rt.put(tree), gpt_fields(cfg))
    out.update(drive_gpt_actor(actor, lambda r: rt.get(r, timeout=600),
                               tokens))
    rt.kill(actor)
    print("CLUSTER_JOB " + json.dumps(out), flush=True)
    return 0


def cluster_client_main(address: str) -> int:
    """The Ray Client of runtime_cluster (path b), a process with no card:
    connect to the proxy, create a num_gpus=1 GPTActor through the
    session, get its logits (a CPU tensor), kill it and end the session;
    prints one CLUSTER_CLIENT line."""
    import torch
    from ray_tpu_torch.util.client import connect
    check(not torch.cuda.is_available(), "the client process sees a card")
    cfg = cluster_config()
    tree, tokens = cluster_inputs(cfg)
    t0 = time.perf_counter()
    c = connect(address, timeout=600)
    out = {"connect_s": time.perf_counter() - t0,
           "session_pid": c.ping()["pid"]}
    out["session_visible"] = process_visible_devices(out["session_pid"])
    t0 = time.perf_counter()
    tree_ref = c.put(tree)
    out["put_params_s"] = time.perf_counter() - t0
    actor = c.remote(num_gpus=1)(GPTActor).remote(tree_ref, gpt_fields(cfg))
    out.update(drive_gpt_actor(actor, c.get, tokens))
    c.kill(actor)
    t0 = time.perf_counter()
    c.disconnect(end_session=True)
    out["disconnect_s"] = time.perf_counter() - t0
    print("CLUSTER_CLIENT " + json.dumps(out), flush=True)
    return 0


def tagged_line(text: str, tag: str) -> dict:
    """The JSON of the one line of ``text`` that starts with ``tag``."""
    lines = [ln for ln in text.splitlines() if ln.startswith(tag + " ")]
    check(len(lines) == 1, f"{len(lines)} {tag} lines in:\n{text[-3000:]}")
    return json.loads(lines[0][len(tag) + 1:])


def card_back_within(mib_before, after, timeout=60) -> int:
    """Wait until the card's memory.used is back within CARD_MIB_SLACK of
    ``mib_before``; returns the reading."""
    deadline = time.monotonic() + timeout
    while True:
        mib = card_used_mib()
        if mib <= mib_before + CARD_MIB_SLACK:
            return mib
        check(time.monotonic() < deadline, f"the card's memory.used is "
              f"{mib} MiB after {after}, {mib_before} before")
        time.sleep(0.2)


def check_gpt_path(name, res, want, cfg):
    """A path's GPTActor: logits (by hash, shape and dtype) the in-process
    forward's ``want``, 12 flash forward launches, the card named 0."""
    got = {k: res[k] for k in want}
    check(got == want, f"{name}: the actor's logits {got} differ from the "
          f"in-process forward's {want}")
    check(res["launches"] == [cfg.num_layers, 0, 0, 0, 0, 0],
          f"{name}: the actor launched {res['launches']}")
    check(res["actor_visible"] == "0",
          f"{name}: the actor saw CUDA_VISIBLE_DEVICES="
          f"{res['actor_visible']!r}")


def cluster_cli_and_jobs(cfg, want, mib_before) -> dict:
    """Path (a): a CLI-started head, a GPT job, a card-holding job stopped
    with ``job stop``, ``list actors`` and ``stop``."""
    import ray_tpu_torch as rt
    sess_dir = tempfile.mkdtemp(prefix="rtt_chip_cli_")
    env = {**os.environ, "RT_SESSION_DIR": sess_dir}

    def cli(*argv, timeout=600):
        r = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *argv],
                           env=env, cwd=ROOT, capture_output=True, text=True,
                           timeout=timeout)
        check(r.returncode == 0, f"`{' '.join(argv)}` exited "
              f"{r.returncode}:\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        return r.stdout

    wd = tempfile.mkdtemp(prefix="rtt_chip_job_")
    with open(os.path.join(wd, "entry.py"), "w") as f:
        f.write(f"import sys\nsys.path.insert(0, {ROOT!r})\n"
                f"import chip_smoke\n"
                f"sys.exit(chip_smoke.cluster_job_main("
                f"'--hold' in sys.argv))\n")
    renv = json.dumps({"working_dir": wd})
    out = {}
    try:
        t0 = time.perf_counter()
        cli("start", "--head", "--port", "0", "--num-cpus", "4",
            "--object-store-memory", str(RUNTIME_STORE_BYTES))
        out["head_start_s"] = time.perf_counter() - t0
        with open(os.path.join(sess_dir, "cluster.json")) as f:
            session = json.load(f)
        total = json.loads(cli("status"))["resources"]["total"]
        types = [k for k in total if k.startswith("accelerator_type:")]
        check(total.get("GPU") == 1.0 and len(types) == 1 and
              "H100" in types[0], f"the CLI head advertises {total}")
        out["status_resources"] = total
        rt.init(address=session["gcs_address"])
        try:
            t0 = time.time()
            res = cli("job", "submit", "--wait", "--runtime-env-json", renv,
                      "--", sys.executable, "entry.py")
            out["job_end_to_end_s"] = time.time() - t0
            sid = re.search(r"submitted: (\S+)", res).group(1)
            job = tagged_line(res, "CLUSTER_JOB")
            check(job["cuda_visible_devices"] == "" and
                  not job["cuda_available"],
                  f"the job's entrypoint saw {job['cuda_visible_devices']!r}")
            check_gpt_path("job", job, want, cfg)
            check(job["logits_device"] == "cpu",
                  "the entrypoint got its logits on a card")
            check(tagged_line(cli("job", "logs", sid), "CLUSTER_JOB") == job,
                  "`job logs` does not give the job's output")
            out["job_submit_to_running_s"] = job.pop("started_at") - t0
            out["job"] = job
            free_card(True)
            out["mib_after_job"] = card_back_within(mib_before, "the job")

            res = cli("job", "submit", "--runtime-env-json", renv, "--",
                      sys.executable, "entry.py", "--hold")
            sid2 = re.search(r"submitted: (\S+)", res).group(1)
            deadline = time.monotonic() + 600
            while "CLUSTER_JOB_HOLDING" not in (logs := cli("job", "logs",
                                                            sid2)):
                check(time.monotonic() < deadline,
                      f"the holding job never held the card:\n{logs}")
                time.sleep(0.5)
            held = tagged_line(logs, "CLUSTER_JOB_HOLDING")
            out["held_mib"] = card_used_mib()
            check(out["held_mib"] >= mib_before + 1024 and
                  rt.available_resources().get("GPU", 0) == 0,
                  f"the holding job's card: memory.used {out['held_mib']} "
                  f"MiB (before {mib_before}), GPU "
                  f"{rt.available_resources().get('GPU')}")
            t0 = time.perf_counter()
            cli("job", "stop", sid2)
            while (status := cli("job", "status", sid2).strip()) not in (
                    "STOPPED", "SUCCEEDED", "FAILED"):
                time.sleep(0.2)
            check(status == "STOPPED", f"the stopped job is {status}")
            check("CLUSTER_JOB_RELEASED" in cli("job", "logs", sid2),
                  "the stopped job never released its holder")
            free_card(True)
            out["mib_after_job_stop"] = card_back_within(
                mib_before, "job stop")
            out["job_stop_to_card_back_s"] = time.perf_counter() - t0
            out["holder_reserved_mib"] = held["holder_reserved_mib"]
            actors = json.loads(cli("list", "actors"))
            out["actors_listed"] = len(actors)
            on_card = [a for a in actors if a["state"] == "ALIVE"
                       and (a.get("resources") or {}).get("GPU")]
            check(on_card == [], f"live actors hold the card: {on_card}")
        finally:
            rt.shutdown()
    finally:
        stopped = cli("stop")
    pids = [n["pid"] for n in session["nodes"]]
    deadline = time.monotonic() + 60
    while not all(process_gone(p) for p in pids):
        check(time.monotonic() < deadline, f"`stop` left daemons {pids}: "
              f"{stopped}")
        time.sleep(0.2)
    out["mib_after_stop"] = card_back_within(mib_before, "stop")
    out["stopped_daemon_pids"] = pids
    for path in (sess_dir, wd):
        shutil.rmtree(path, ignore_errors=True)
    return out


def cluster_client(cfg, want, mib_before) -> dict:
    """Path (b): a proxy on a head, a client in a card-less process."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.util import state
    from ray_tpu_torch.util.client import start_proxy
    info = rt.init(num_cpus=4, object_store_memory=RUNTIME_STORE_BYTES)
    try:
        proxy, address = start_proxy(info["gcs_address"])
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; sys.exit("
             "chip_smoke.cluster_client_main(sys.argv[1]))", address],
            cwd=ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
            capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        check(r.returncode == 0, f"the client exited {r.returncode}:\n"
              f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        res = tagged_line(r.stdout, "CLUSTER_CLIENT")
        check_gpt_path("client", res, want, cfg)
        check(res["logits_device"] == "cpu",
              f"the client got its logits on {res['logits_device']}")
        check(res["session_visible"] == "", f"the client's session saw "
              f"CUDA_VISIBLE_DEVICES={res['session_visible']!r}")
        deadline = time.monotonic() + 60
        while not process_gone(res["session_pid"]) or proxy.sessions:
            check(time.monotonic() < deadline, "the session outlived "
                  f"end_session: {proxy.sessions}")
            time.sleep(0.2)
        actors = [a for a in state.list_actors()
                  if (a.get("resources") or {}).get("GPU")]
        check(len(actors) == 1 and actors[0]["state"] == "DEAD",
              f"the client's actor lives on: {actors}")
        free_card(True)
        res["mib_after_disconnect"] = card_back_within(mib_before,
                                                       "disconnect")
        res["client_process_s"] = wall
    finally:
        rt.shutdown()
    return res


def process_visible_devices(pid):
    """CUDA_VISIBLE_DEVICES of a live process of this machine (None when
    unset)."""
    with open(f"/proc/{pid}/environ", "rb") as f:
        env = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0")
                   if b"=" in kv)
    value = env.get(b"CUDA_VISIBLE_DEVICES")
    return None if value is None else value.decode()


class _StoreSizedNodes:
    """A cluster_utils.Cluster whose added nodes get the runtime phase's
    store size (the actor's 498 MB of params land in its node's store)."""

    def __init__(self, cluster):
        self.cluster = cluster

    def add_node(self, **kwargs):
        return self.cluster.add_node(object_store_memory=RUNTIME_STORE_BYTES,
                                     **kwargs)

    def remove_node(self, node):
        self.cluster.remove_node(node)


def cluster_autoscaler(dev, cfg, tree, tokens, want, mib_before) -> dict:
    """Path (c): a card-less head, a LocalNodeProvider and a Monitor with
    one GPU node type; a queued num_gpus=1 GPTActor scales it up, and its
    idle node is ended once the actor is killed."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import (AutoscalerConfig,
                                          LocalNodeProvider, Monitor,
                                          NodeTypeConfig)
    from ray_tpu_torch.cluster_utils import Cluster
    cluster = Cluster(head_node_args={
        "num_cpus": 2, "object_store_memory": RUNTIME_STORE_BYTES,
        "env": {"RT_NODE_RECONNECT_GRACE_S": str(NODE_DEATH_GRACE_S)}})
    monitor = None
    out = {"idle_timeout_s": CLUSTER_IDLE_S}
    try:
        rt.init(address=cluster.address)
        check(rt.cluster_resources().get("GPU", 0) == 0,
              f"the head advertises a card: {rt.cluster_resources()}")
        provider = LocalNodeProvider(_StoreSizedNodes(cluster))
        gpu1 = NodeTypeConfig("gpu1", {"CPU": 4.0, "GPU": 1.0},
                              min_workers=0, max_workers=1)
        monitor = Monitor(provider, AutoscalerConfig(
            node_types=[gpu1], idle_timeout_s=CLUSTER_IDLE_S),
            update_interval_s=0.5).start()
        tree_ref = rt.put(tree)
        t0 = time.perf_counter()
        actor = rt.remote(GPTActor).options(num_gpus=1).remote(
            tree_ref, gpt_fields(cfg))
        deadline = time.monotonic() + 300
        while not provider.non_terminated_nodes():
            check(time.monotonic() < deadline, "no GPU node was launched")
            time.sleep(0.05)
        launched = time.perf_counter()
        out["demand_to_launch_s"] = launched - t0
        nodes = provider.non_terminated_nodes()
        res = drive_gpt_actor(actor, lambda r: rt.get(r, timeout=600),
                              tokens)
        # the actor's first call starts as the node is seen
        out["launch_to_first_answer_s"] = res["first_answer_s"]
        check_gpt_path("autoscaler", res, want, cfg)
        check(res["actor_node_id"] != cluster.head_node.node_id and
              [n.node_type for n in nodes] == ["gpu1"],
              f"the actor runs on {res['actor_node_id']}, nodes {nodes}")
        out.update(res)
        rt.kill(actor)
        t0 = time.perf_counter()
        deadline = time.monotonic() + 300
        while provider.non_terminated_nodes():
            check(time.monotonic() < deadline, "the idle GPU node lives on")
            time.sleep(0.1)
        out["idle_to_terminate_s"] = time.perf_counter() - t0
        # this driver sees the card, so the logits came back onto it
        empty_cache(dev)
        out["mib_after_terminate"] = card_back_within(mib_before,
                                                      "the node's end")
    finally:
        if monitor:
            monitor.stop()
        rt.shutdown()
        cluster.shutdown()
    return out


def cluster_microbenchmark(smi) -> list:
    """Path (d): the runtime's microbenchmark (--quick) on the card's
    host: host numbers (a local cluster of CPU workers), printed each
    with the card beside it."""
    r = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch._private.microbenchmark",
         "--quick"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    check(r.returncode == 0, f"the microbenchmark exited {r.returncode}:\n"
          f"{r.stderr[-3000:]}")
    recs = [json.loads(ln) for ln in r.stdout.splitlines()
            if ln.startswith("{")]
    check(len(recs) == 7 and all(m["value"] > 0 for m in recs),
          f"the microbenchmark printed {recs}")
    for rec in recs:
        emit("microbenchmark", card=smi,
             measured_on="the card's host CPU (no card used)", **rec)
    return recs


def runtime_cluster(dev, cfg, tree, smi) -> dict:
    """The cluster layer on the card (see the module docstring), with
    ``tree`` GPT-2-small's params as the runtime phase made them; returns
    the step's numbers and the paths' flash launches."""
    check(cfg == cluster_config(), "runtime_cluster's configuration "
          "differs from the one its job and client build")
    tokens = cluster_tokens(cfg)
    logits, fwd_ms, _ = in_process_forward(dev, cfg, tree, tokens, timed=1)
    want = {"logits_sha256": tensor_sha256(logits),
            "logits_shape": list(logits.shape),
            "logits_dtype": str(logits.dtype).removeprefix("torch.")}
    del logits
    empty_cache(dev)
    mib_before = card_used_mib()
    out = {"tokens": list(CLUSTER_TOKENS), "in_process_forward_ms": fwd_ms,
           "in_process": want, "card_mib_before": mib_before}
    for name, fn in (
            ("cli", lambda: cluster_cli_and_jobs(cfg, want, mib_before)),
            ("client", lambda: cluster_client(cfg, want, mib_before)),
            ("autoscaler", lambda: cluster_autoscaler(
                dev, cfg, tree, tokens, want, mib_before))):
        t0 = time.perf_counter()
        out[name] = fn()
        out[name]["step_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["microbenchmark"] = cluster_microbenchmark(smi)
    out["microbenchmark_s"] = time.perf_counter() - t0
    out["launches"] = [sum(x) for x in zip(
        out["cli"]["job"]["launches"], out["client"]["launches"],
        out["autoscaler"]["launches"])]
    return out


def phase_runtime(dev, cfg, limit, smi, serve_phase=None, train_cfg=None,
                  train_ms=None):
    """The runtime core on the card (see the module docstring).
    ``train_cfg`` is the training configuration of runtime_train (bf16,
    flash, remat dots, its ce_block) and ``train_ms`` the in-process
    ms/step printed beside the trainer's."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.models import gpt_init, params_to_numpy
    free = shm_free_bytes()
    print(f"runtime: /dev/shm has {free} bytes free; the store needs "
          f"{RUNTIME_STORE_BYTES}", flush=True)
    check(free >= RUNTIME_STORE_BYTES,
          f"/dev/shm has {free} bytes free, too little for the runtime "
          f"phase's {RUNTIME_STORE_BYTES}-byte object store")
    check("RT_NUM_GPUS" not in os.environ,
          "RT_NUM_GPUS is set: the daemon must find the card itself")
    tree = params_to_numpy(gpt_init(SEED, cfg, device="cpu"))
    gen = torch.Generator().manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, RUNTIME_TOKENS, generator=gen)
    t0 = time.perf_counter()
    info = rt.init(num_cpus=4, object_store_memory=RUNTIME_STORE_BYTES)
    init_s = time.perf_counter() - t0
    try:
        res = rt.cluster_resources()
        print(f"runtime: cluster_resources {json.dumps(res)}", flush=True)
        types = [k for k in res if k.startswith("accelerator_type:")]
        check(res.get("GPU") == 1.0, f"the node advertises {res}, not GPU: 1")
        check(len(types) == 1 and "H100" in types[0],
              f"the node's accelerator_type is {types}")
        out = runtime_steps(dev, cfg, tree, tokens, limit=limit)
        t0 = time.perf_counter()
        serve_out = runtime_serve(dev, cfg, tree, info["dashboard_address"],
                                  out["limit"], serve_phase=serve_phase)
        serve_out["step_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        train_out = runtime_train(dev, train_cfg, train_ms)
        train_out["step_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        data_out = runtime_data(dev, train_cfg, train_out)
        data_out["step_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tune_out = runtime_tune(dev, train_cfg, train_out)
        tune_out["step_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rllib_out = runtime_rllib(dev)
        rllib_out["step_s"] = time.perf_counter() - t0
    finally:
        rt.shutdown()
    left = [e for e in os.listdir("/dev/shm")
            if re.match(rf"rtt?_{info['pid']}_", e)]
    check(left == [], f"the session left segments {left}")
    observe = out.pop("observe")
    emit("runtime", card=smi, init_s=init_s, resources=res,
         store_bytes=RUNTIME_STORE_BYTES, shm_free_bytes=free,
         tokens=list(RUNTIME_TOKENS), **out)
    emit("runtime_observe", card=smi, **observe)
    emit("runtime_serve", card=smi, **serve_out)
    emit("runtime_train", card=smi, **train_out)
    emit("runtime_data", card=smi, **data_out)
    emit("runtime_tune", card=smi, **tune_out)
    emit("runtime_rllib", card=smi, **rllib_out)
    t0 = time.perf_counter()
    death = runtime_node_death(dev, cfg, tree, tokens)
    emit("runtime_node_death", card=smi,
         step_s=time.perf_counter() - t0, **death)
    t0 = time.perf_counter()
    cluster = runtime_cluster(dev, cfg, tree, smi)
    emit("runtime_cluster", card=smi, step_s=time.perf_counter() - t0,
         **cluster)
    out["cluster_launches"] = cluster["launches"]
    out["actor_launches"] = tuple(a + b for a, b in zip(
        out["actor_launches"], death["actor_launches"]))
    out["serve_launches"] = serve_out["flash_launches"]
    out["train_launches"] = train_out["launches"]
    out["data_launches"] = data_out["launches"]
    out["tune_launches"] = tune_out["launches"]
    return out


# ---------------------------------------------------------- parallel layer


def phase_dist_single(dev, cfg, B=8, S=1024, ring_shape=(4, 1024, 12, 64)):
    """The parallel layer in a one-rank NCCL world on the card (one card:
    multi-rank runs are held on the CPU over gloo, in the tests): the
    process group from a FileStore in a temporary directory, destroyed at
    the end.  ``MeshSpec().build()`` on cuda; ``shard_params`` of the
    model; one sharded AdamW step (flash under the mesh) against the same
    step unsharded, in bf16 (loss and grad norm within DIST_RTOL, exact
    flash launches); each collective once (identities on a one-rank
    group); ring attention at sp=1 on [4,12,1024,64] bf16 (as [B, S, N,
    H]) no further from the plain causal attention in f32 than
    REL_MULT x the plain attention in bf16;
    ``make_ring_attention_fn`` refusing sp=1.  On the CPU (a rehearsal at
    a tiny config) it runs over gloo and launches no kernel."""
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.ops.flash_attention import _dense_reference
    from ray_tpu_torch.ops.ring_attention import (make_ring_attention_fn,
                                                  ring_attention)
    from ray_tpu_torch.parallel import (AXIS_ORDER, LogicalAxisRules,
                                        MeshSpec, P, all_gather, all_reduce,
                                        all_to_all, barrier_sum,
                                        ppermute_ring, psum_scatter,
                                        shard_map, shard_params)
    from ray_tpu_torch.models.gpt import gpt_param_axes

    fam = family(cfg)
    cuda = dev.type == "cuda"          # gloo and "cpu" only to rehearse
    with one_rank_world(dev):
        spec = MeshSpec()
        mesh = spec.build() if cuda else spec.build("cpu")
        check(mesh.device_type == dev.type and
              tuple(mesh.mesh_dim_names) == AXIS_ORDER,
              f"mesh {mesh} is not the six named dims on cuda")
        rules = LogicalAxisRules.for_transformer(spec)
        gen = torch.Generator().manual_seed(SEED + 2)
        tokens = torch.randint(0, cfg.vocab_size, (B, S + 1),
                               generator=gen).to(dev)
        steps = {}
        for name in ("unsharded", "sharded"):
            params = fam.init(SEED, cfg, device=dev)
            mesh_kw = {}
            if name == "sharded":
                params = shard_params(params, mesh, rules,
                                      gpt_param_axes(cfg))
                mesh_kw = dict(rules=rules, mesh=mesh)
            leaves = [q.requires_grad_(True) for _, q in named_leaves(params)]
            opt = torch.optim.AdamW(leaves, lr=3e-4, betas=(0.9, 0.95),
                                    eps=1e-8, weight_decay=1e-4)
            step = fam.train_step(cfg, opt, **mesh_kw)
            reset_launch_counts()
            m = step(params, {"tokens": tokens})
            sync(dev)
            steps[name] = (float(m["loss"]), float(m["grad_norm"]),
                           launch_counts())
            del params, opt, leaves, step
            empty_cache(dev)
        (l0, n0, k0), (l1, n1, k1) = steps["unsharded"], steps["sharded"]
        L = cfg.num_layers if cuda else 0
        loss_rel, norm_rel = abs(l1 - l0) / abs(l0), abs(n1 - n0) / abs(n0)

        x = torch.arange(8.0, device=dev)
        rep, one = P(None), (P("tp"),)
        got = {
            "all_reduce": shard_map(lambda v: all_reduce(v, "tp"), mesh,
                                    one, P("tp"))(x),
            "all_gather": shard_map(lambda v: all_gather(v, "tp"), mesh,
                                    one, rep)(x),
            "psum_scatter": shard_map(lambda v: psum_scatter(v, "tp"), mesh,
                                      one, P("tp"))(x),
            "all_to_all": shard_map(lambda v: all_to_all(
                v[None], "tp", 1, 0)[0], mesh, one, P("tp"))(x),
            "ppermute_ring": shard_map(lambda v: ppermute_ring(v, "tp"),
                                       mesh, one, P("tp"))(x),
            "barrier_sum": shard_map(lambda v: v + barrier_sum("tp"), mesh,
                                     one, P("tp"))(x.int()),
        }
        collectives_ok = {k: bool((v.full_tensor().float() == x).all())
                          for k, v in got.items()}

        qkv = case_inputs(torch.Generator(device=dev).manual_seed(SEED), dev,
                          ring_shape, "bfloat16", False, 3)
        ring = ring_attention(*qkv, mesh).full_tensor()
        ref = _dense_reference(*(t.float() for t in qkv), True, None)
        ring_err = float((ring.float() - ref).abs().max())
        # The ring's scores are bf16 products, as the reference's, so it is
        # held to the plain bf16 attention's distance from f32, as the
        # training checks hold the bf16 grads.
        dense_err = float((_dense_reference(*qkv, True, None).float()
                           - ref).abs().max())
        refused = False
        try:
            make_ring_attention_fn(mesh)
        except ValueError:
            refused = True
        emit("dist_single", backend=dist.get_backend(), world_size=1,
             mesh=spec.axis_sizes, batch=B, seq=S,
             loss_unsharded=l0, loss_sharded=l1, loss_rel_diff=loss_rel,
             grad_norm_unsharded=n0, grad_norm_sharded=n1,
             grad_norm_rel_diff=norm_rel, rtol=DIST_RTOL,
             launches_sharded_step=dict(zip(KERNEL_NAMES, k1)),
             collectives=collectives_ok, ring_sp1_shape=list(ring_shape),
             ring_sp1_max_abs_err=ring_err,
             dense_bf16_max_abs_err=dense_err, rel_mult=REL_MULT,
             ring_fn_refuses_sp1=refused,
             card=nvidia_smi_line() if cuda else None)
        check(loss_rel <= DIST_RTOL and norm_rel <= DIST_RTOL,
              f"sharded step {l1}, {n1} against unsharded {l0}, {n0}")
        want = (2 * L, L, L, 0, 0, 0)
        check(k0 == want and k1 == want,
              f"flash launches of a step {k0} unsharded, {k1} sharded, "
              f"expected {want}")
        check(all(collectives_ok.values()), f"collectives {collectives_ok}")
        check(ring_err <= REL_MULT * dense_err,
              f"ring attention at sp=1 off by {ring_err}, bf16 dense by "
              f"{dense_err}")
        check(refused, "make_ring_attention_fn took a mesh with sp=1")


@contextlib.contextmanager
def one_rank_world(dev):
    """A one-rank process group (NCCL on the card, gloo on the CPU) from a
    FileStore in a temporary directory, destroyed at the end."""
    import torch.distributed as dist
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.FileStore(os.path.join(tmp, "store"),
                                                 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


# Per-leaf gradient bound of the pipeline's full-width check: each leaf's
# ||g - g0|| / ||g0|| against the unpipelined step's first gradients, the
# same bf16 model with the batch's sums in another order (set from the
# readings on the card, see PERF.md).
PIPE_LEAF_RTOL = 1e-2


def phase_pipeline(dev, cfg, B=32, S=1024, M=8, steps=4, small=None):
    """The pipeline (``parallel/pipeline.py``) in a one-rank world on the
    card: ``MeshSpec().build()`` on cuda, so pp = 1 and both schedules run
    all M microbatches through the one stage.  (a) An f32 rehearsal at the
    ``small`` config: ``gpt_loss_pipelined`` and ``gpt_loss_1f1b`` against
    ``gpt_loss``, loss within 1e-5 relative, each grad leaf within 1e-4 of
    its max |grad|.  (b) ``cfg`` (GPT-2-small, bf16, flash, full remat,
    the full-logit head) at [B, S]: the unpipelined step, the GPipe step
    and the 1F1B step (M microbatches) from the same init, each with its
    own AdamW (3e-4, b2 0.95, wd 1e-4): the first step's loss and grad
    norm of each schedule within DIST_RTOL of the unpipelined one's, each
    grad leaf of that step within PIPE_LEAF_RTOL (relative distance) of
    the unpipelined one's, exact flash launches per step (each
    microbatch: the forward, the backward's recompute, dq, dk/dv per
    layer), then ``steps`` steps timed one by one: ms/step (mean, min,
    max), tokens/s, peak memory; on the card the device time of one more step
    (torch.profiler, kernels only) and the idle share of the timed step
    it leaves.  The launch counts are set to 0 just before each
    schedule's steps and read just after.  On the CPU (a
    rehearsal at tiny configs) it runs over gloo and launches no
    kernel."""
    import torch
    from torch.profiler import ProfilerActivity
    from ray_tpu_torch.models.gpt import make_train_state, make_train_step
    from ray_tpu_torch.parallel import MeshSpec
    from ray_tpu_torch.parallel import pipeline as pl

    cuda = dev.type == "cuda"
    small = small or small_gpt_config()
    out = {}
    with one_rank_world(dev):
        mesh = MeshSpec().build() if cuda else MeshSpec().build("cpu")
        check(mesh.device_type == dev.type, f"mesh {mesh} not on {dev}")

        # (a) f32 rehearsal
        params, _ = make_train_state(SEED, small, device=dev)
        gen = torch.Generator().manual_seed(SEED + 3)
        tokens = torch.randint(0, small.vocab_size, (8, small.max_seq_len
                                                     + 1), generator=gen)
        batch = {"tokens": tokens.to(dev)}
        want = _loss_and_grads(params, batch["tokens"], small)
        leaves = [p for _, p in named_leaves(params)]
        rehearsal = {}
        for name, fn in (("gpipe", pl.gpt_loss_pipelined),
                         ("1f1b", pl.gpt_loss_1f1b)):
            loss = fn(params, batch, small, mesh, num_microbatches=4)
            loss.backward()
            errs = _grad_errs([p.grad for p in leaves], want[1])
            for p in leaves:
                p.grad = None
            rehearsal[name] = {
                "loss_rel_diff": abs(float(loss) - want[0]) / abs(want[0]),
                "worst_grad_err_over_max": max(errs)}
        del params, leaves
        out["f32_rehearsal"] = dict(rehearsal, config=dict(
            layers=small.num_layers, heads=small.num_heads,
            width=small.embed_dim, vocab=small.vocab_size,
            batch=8, seq=small.max_seq_len, microbatches=4,
            attention=small.attention))
        for name, r in rehearsal.items():
            check(r["loss_rel_diff"] <= 1e-5 and
                  r["worst_grad_err_over_max"] <= 1e-4,
                  f"f32 {name} rehearsal off gpt_loss: {r}")

        # (b) GPT-2-small at [B, S]
        L = cfg.num_layers if cuda else 0
        gen = torch.Generator().manual_seed(SEED + 4)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S + 1),
                                         generator=gen).to(dev)}
        makers = {
            "unpipelined": lambda opt: make_train_step(cfg, opt),
            "gpipe": lambda opt: pl.make_pipeline_train_step(
                cfg, opt, mesh, num_microbatches=M),
            "1f1b": lambda opt: pl.make_1f1b_train_step(
                cfg, opt, mesh, num_microbatches=M)}
        want_launches = {"unpipelined": [2 * L, L, L, 0, 0, 0],
                         "gpipe": [2 * M * L, M * L, M * L, 0, 0, 0],
                         "1f1b": [2 * M * L, M * L, M * L, 0, 0, 0]}
        runs, first_grads = {}, {}
        for name, make in makers.items():
            params, opt = make_train_state(SEED, cfg, learning_rate=3e-4,
                                           weight_decay=1e-4, device=dev)
            step = make(opt)
            empty_cache(dev)
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            reset_launch_counts()             # this schedule's path starts
            first = step(params, batch)
            sync(dev)
            first_launches = list(launch_counts())
            # the first step's grads, kept on the host (off the peak)
            leaf_names = [n for n, _ in named_leaves(params)]
            first_grads[name] = [p.grad.detach().to("cpu")
                                 for _, p in named_leaves(params)]
            metrics, step_ms = [], []
            for _ in range(steps):
                t0 = time.perf_counter()
                metrics.append(step(params, batch))
                sync(dev)
                step_ms.append((time.perf_counter() - t0) * 1e3)
            secs = sum(step_ms) / 1e3
            launches = launch_counts()        # ... and ends here
            runs[name] = {
                "loss": float(first["loss"]),
                "grad_norm": float(first["grad_norm"]),
                "losses": [float(first["loss"])] +
                [float(m["loss"]) for m in metrics],
                "ms_per_step": secs / steps * 1e3,
                "ms_steps": step_ms,
                "tokens_per_s": B * S * steps / secs,
                "peak_memory_gb": (torch.cuda.max_memory_allocated(dev)
                                   / 1e9 if cuda else None),
                "launches_first_step": dict(zip(KERNEL_NAMES,
                                                first_launches)),
                "launches": list(launches)}
            check(first_launches == want_launches[name] and
                  list(launches) == [n * (steps + 1)
                                     for n in want_launches[name]],
                  f"{name}: launches {first_launches} in the first step, "
                  f"{list(launches)} in all, expected "
                  f"{want_launches[name]} a step")
            if cuda:
                # device time of one more step (kernels only: tracing the
                # host's ops would slow the host-bound step it measures)
                kernels, _ = profiled(lambda: step(params, batch), 1,
                                      [ProfilerActivity.CUDA])
                _, busy, flash, by_class = kernel_breakdown(kernels, 1)
                runs[name].update(
                    device_ms_per_step=busy,
                    device_idle_share=1 - busy / runs[name]["ms_per_step"],
                    flash_ms_per_step=flash, device_ms_by_class=by_class)
            del params, opt, step, first, metrics
            empty_cache(dev)
        base = runs["unpipelined"]
        for name in ("gpipe", "1f1b"):
            r = runs[name]
            r["loss_rel_diff"] = abs(r["loss"] - base["loss"]) / base["loss"]
            r["grad_norm_rel_diff"] = (abs(r["grad_norm"] - base["grad_norm"])
                                       / base["grad_norm"])
            dists = [_rel_dist(g.to(dev), g0.to(dev)) for g, g0 in
                     zip(first_grads[name], first_grads["unpipelined"])]
            worst = max(range(len(dists)), key=dists.__getitem__)
            r["grad_leaf_rel_dist_max"] = dists[worst]
            r["grad_leaf_rel_dist_worst_leaf"] = leaf_names[worst]
            r["grad_leaf_rel_dist_median"] = sorted(dists)[len(dists) // 2]
        del first_grads
        emit("pipeline", world_size=1, mesh=MeshSpec().axis_sizes,
             batch=B, seq=S, microbatches=M, dtype=str(cfg.dtype),
             attention=cfg.attention, remat="full (every block, a stage)",
             head="full logits", timed_steps=steps, rtol=DIST_RTOL,
             leaf_rtol=PIPE_LEAF_RTOL,
             launches_per_step=want_launches, **out, **runs,
             card=nvidia_smi_line() if cuda else None)
        for name in ("gpipe", "1f1b"):
            r = runs[name]
            check(r["loss_rel_diff"] <= DIST_RTOL and
                  r["grad_norm_rel_diff"] <= DIST_RTOL,
                  f"{name} first step {r['loss']}, {r['grad_norm']} against "
                  f"unpipelined {base['loss']}, {base['grad_norm']}")
            check(r["grad_leaf_rel_dist_max"] <= PIPE_LEAF_RTOL,
                  f"{name} first step: grad leaf "
                  f"{r['grad_leaf_rel_dist_worst_leaf']} at relative "
                  f"distance {r['grad_leaf_rel_dist_max']} from the "
                  f"unpipelined step's")
            check(all(math.isfinite(x) for x in r["losses"]),
                  f"{name} losses not finite: {r['losses']}")
    return {name: {"launches": r["launches"], "per_step":
                   want_launches[name]} for name, r in runs.items()}


def small_gpt_config():
    """The f32 rehearsal's config: 4 layers of 4 heads of 16, width 64,
    vocab 256, seq 128, flash attention (its f32 kernels)."""
    import torch
    from ray_tpu_torch.models import GPTConfig
    return GPTConfig(vocab_size=256, max_seq_len=128, num_layers=4,
                     num_heads=4, embed_dim=64, dtype=torch.float32,
                     attention="flash")


def repo_text_bytes():
    """The bytes of the repository's own ``*.md`` files beside this script,
    in name order: text that needs no download."""
    import pathlib
    root = pathlib.Path(__file__).resolve().parent
    files = sorted(root.glob("*.md"))
    check(files, f"no *.md files beside {__file__}")
    return b"".join(f.read_bytes() for f in files), [f.name for f in files]


def byte_baselines(train, targets_prev, targets):
    """Held-out cross-entropy (nats a byte) of two models that read no
    context beyond the current byte, fitted on ``train``: the unigram
    frequencies (add-one) and the bigram frequencies P(next | current),
    smoothed toward the unigram.  A transformer reaches the bigram level
    without attention; only a loss below it shows attention at work."""
    import torch
    uni = (torch.bincount(train, minlength=256).double() + 1) / (
        len(train) + 256)
    pairs = torch.zeros(256, 256, dtype=torch.float64)
    pairs.index_put_((train[:-1], train[1:]),
                     torch.ones(len(train) - 1, dtype=torch.float64),
                     accumulate=True)
    bi = (pairs + uni[None]) / (pairs.sum(1, keepdim=True) + 1)
    return (float(-uni[targets].log().mean()),
            float(-bi[targets_prev, targets].log().mean()))


# How far below the bigram baseline (nats a byte, held out) the trained
# model's loss must be for its top-1 figures to count as trained weights.
TOP1_BELOW_BIGRAM = 0.3
# The copy corpus: windows of [span | its copy] pairs, each span COPY_SPAN
# bytes drawn from a Zipf law over the 256 byte values (p ~ 1/rank, ranks a
# seeded permutation).  A copy byte is predictable only through attention
# (64 positions back); a span byte's best guess is the most likely value,
# ahead of the next by ln 2 nats, so its top-1 does not hang on a tie.
COPY_SPAN = 64


def copy_task_rows(gen, n, S, probs, span=COPY_SPAN):
    """``n`` windows of S + 1 byte tokens: spans and their copies, the
    window starting on a span."""
    import torch
    pairs = -(-(S + 1) // (2 * span))
    spans = torch.multinomial(probs, n * pairs * span, replacement=True,
                              generator=gen).view(n, pairs, 1, span)
    return spans.expand(n, pairs, 2, span).reshape(n, -1)[:, :S + 1]


def top1_figures(dev, fam, params, cfg, windows, train):
    """Held-out figures of one corpus on ``windows`` [rows, S + 1]: the f32
    dense forward's cross-entropy beside the unigram and bigram baselines
    fitted on ``train``, bf16 top-1 agreement of flash with dense and of
    each with f32, the bf16 logit error and the share of positions whose
    f32 top-2 gap is under it (all of them again over the 256 byte logits
    only, under ``byte_logits``), and whether the corpus closes ROADMAP C1
    (loss TOP1_BELOW_BIGRAM under the better baseline, and flash with
    dense on 99% of the positions)."""
    import torch
    tokens, targets = windows[:, :-1].to(dev), windows[:, 1:]
    with torch.no_grad():
        logits = {name: fam.forward(params, tokens, dataclasses.replace(
            cfg, dtype=dt, attention=att))
            for name, dt, att in (("f32", torch.float32, "dense"),
                                  ("flash", torch.bfloat16, "flash"),
                                  ("dense", torch.bfloat16, "dense"))}
    f32 = logits["f32"]
    held_ce = float(torch.nn.functional.cross_entropy(
        f32.float().flatten(0, 1), targets.flatten().to(dev)))
    unigram_ce, bigram_ce = byte_baselines(train, windows[:, :-1].flatten(),
                                           targets.flatten())
    top = {k: v.argmax(-1) for k, v in logits.items()}
    err = max(float((logits[k] - f32).abs().max())
              for k in ("flash", "dense"))
    top2 = f32.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    agree = {f"bf16_top1_{a}_vs_{b}": float((top[a] == top[b]).float()
                                            .mean())
             for a, b in (("flash", "dense"), ("flash", "f32"),
                          ("dense", "f32"))}
    # The same over the 256 byte logits only: byte training never touches
    # the other rows of the head, so their error says nothing of the path.
    byte = {k: v[..., :256] for k, v in logits.items()}
    byte_err = max(float((byte[k] - byte["f32"]).abs().max())
                   for k in ("flash", "dense"))
    byte_top2 = byte["f32"].topk(2, dim=-1).values
    byte_gap = byte_top2[..., 0] - byte_top2[..., 1]
    byte_top = {k: v.argmax(-1) for k, v in byte.items()}
    bytes_only = dict(
        bf16_max_logit_err=byte_err,
        share_top2_gap_under_bf16_err=float((byte_gap < byte_err).float()
                                            .mean()),
        f32_top2_gap_p05=float(torch.quantile(byte_gap.flatten().float(),
                                              0.05)),
        **{f"bf16_top1_{a}_vs_{b}": float((byte_top[a] == byte_top[b])
                                          .float().mean())
           for a, b in (("flash", "dense"), ("flash", "f32"),
                        ("dense", "f32"))})
    # The better of the two context-free baselines: on the copy corpus the
    # bigram table (65,536 cells from ~2.5M bytes of independent span
    # bytes) fits noise and falls behind the unigram, which a model reaches
    # without attention.
    context_free_ce = min(unigram_ce, bigram_ce)
    trained = held_ce <= context_free_ce - TOP1_BELOW_BIGRAM
    return dict(
        held_out_positions=targets.numel(), held_out_ce=held_ce,
        unigram_ce=unigram_ce, bigram_ce=bigram_ce,
        context_free_ce=context_free_ce, trained=trained, **agree,
        bf16_max_logit_err=err,
        share_top2_gap_under_bf16_err=float((gap < err).float().mean()),
        f32_top2_gap_p05=float(torch.quantile(gap.flatten().float(), 0.05)),
        byte_logits=bytes_only,
        c1_holds=trained and agree["bf16_top1_flash_vs_dense"] >= 0.99)


def phase_top1_trained(dev, cfg, random_top1, B=8, S=1024, steps=300,
                       eval_rows=8, lr=1e-3, warmup=30, copy_rows=8,
                       span=COPY_SPAN):
    """The bf16 top-1 check on trained weights.  GPT-2-small (``cfg``, the
    bf16 flash training configuration) trains ``steps`` AdamW steps on
    byte tokens (ids < 256), learning rate ``lr`` after a linear warmup;
    each step's batch holds ``B`` windows of S + 1 bytes of the first 90%
    of ``repo_text_bytes()`` (drawn from seed SEED + 5) and ``copy_rows``
    windows of the copy corpus (``copy_task_rows``, from seed SEED + 6).
    Then ``top1_figures`` on each corpus's held-out windows: ``eval_rows``
    of the last 10% of the text, and ``eval_rows`` fresh copy windows from
    seed SEED + 7, beside ``random_top1`` (the forward phase's figures on
    random weights).  ROADMAP C1 counts as closed when the copy corpus,
    where the answer needs attention, holds both of its limits; the text
    corpus's figures are kept beside it.  The hard limit is the forward
    phase's, on both corpora: flash bf16 no further from f32 than dense
    bf16, less half a point.  Returns the phase's fields."""
    import torch
    fam = family(cfg)
    text, names = repo_text_bytes()
    data = torch.tensor(list(text), dtype=torch.long)
    cut = int(len(data) * 0.9)
    train, held = data[:cut], data[cut:]
    check(len(held) >= eval_rows * S + 1 and len(train) > 8 * S,
          f"{len(data)} bytes of text are too few for [{B}, {S}] windows")
    ranks = torch.randperm(256, generator=torch.Generator().manual_seed(
        SEED + 6))
    probs = (1.0 / (ranks.double() + 1))
    probs /= probs.sum()
    copy_gen = torch.Generator().manual_seed(SEED + 6)
    params, opt = fam.train_state(SEED, cfg, learning_rate=lr,
                                  weight_decay=0.0, device=dev)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda i: min(1.0, (i + 1) / warmup))
    step = fam.train_step(cfg, opt)
    gen = torch.Generator().manual_seed(SEED + 5)
    t0 = time.perf_counter()
    losses, copy_train = [], []
    for i in range(steps):
        starts = torch.randint(0, len(train) - S - 1, (B,), generator=gen)
        copies = copy_task_rows(copy_gen, copy_rows, S, probs, span)
        copy_train.append(copies)
        batch = {"tokens": torch.cat([torch.stack(
            [train[j:j + S + 1] for j in starts.tolist()]), copies]).to(dev)}
        m = step(params, batch)
        sched.step()
        if i % 50 == 0 or i == steps - 1:
            losses.append(float(m["loss"]))
    sync(dev)
    train_s = time.perf_counter() - t0
    text_fig = top1_figures(dev, fam, params, cfg, torch.stack(
        [held[i * S:(i + 1) * S + 1] for i in range(eval_rows)]), train)
    copy_fig = top1_figures(dev, fam, params, cfg, copy_task_rows(
        torch.Generator().manual_seed(SEED + 7), eval_rows, S, probs, span),
        torch.cat(copy_train).flatten())
    fields = dict(
        texts=names, bytes_train=len(train), bytes_held_out=len(held),
        batch=B, copy_rows=copy_rows, copy_span=span, seq=S,
        steps=steps, learning_rate=lr, warmup_steps=warmup,
        train_s=train_s, losses_every_50=losses,
        below_bigram_required=TOP1_BELOW_BIGRAM, **text_fig,
        copy_task=copy_fig, random_weights=random_top1,
        c1_closed=copy_fig["c1_holds"],
        card=nvidia_smi_line() if dev.type == "cuda" else None)
    emit("top1_trained", **fields)
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"byte training did not learn: {losses}")
    for name, fig in (("text", text_fig), ("copy", copy_fig)):
        check(fig["bf16_top1_flash_vs_f32"] >=
              fig["bf16_top1_dense_vs_f32"] - 0.005,
              f"trained ({name} corpus): bf16 flash top-1 further from the "
              f"f32 forward than dense's")
    del params, opt
    empty_cache(dev)
    return fields


# -------------------------------------------------------------------- main


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the "
              "card", file=sys.stderr)
        return 2
    # A fresh autotune cache, so no file under the card's home can steer
    # the "auto" paths; removed at the end.
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    os.environ["RT_AUTOTUNE_CACHE"] = os.path.join(cache_dir,
                                                   "autotune.jsonl")
    try:
        return run()
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)


# The engine's traffic on both families: 12 requests of 32..512 prompt
# tokens, 64 new tokens each, 8 decode slots, page 16; three f32 streams
# held to the dense forward's greedy tokens over 16 steps.
SERVE = dict(n_req=12, prompt_lo=32, max_prompt=512, max_new=64, page=16,
             max_batch=8, n_checked=3, n_greedy=16)


def model_paths(dev, cfg, train_cfg, B=4, S=1024, train_B=32, serve=SERVE):
    """One family's main paths at full width: the inference path (forward
    [B, S] with flash, then the engine) with the launch counts set to 0
    before it and read after, then the training path at [train_B, S]
    (``phase_train`` counts its timed steps itself).  Returns (the forward
    phase's result, the inference path's launches, the training phase's
    result)."""
    params = family(cfg).init(SEED, cfg, device=dev)
    reset_launch_counts()                     # the inference path starts
    fwd = phase_forward(dev, cfg, params, B=B, S=S)
    fwd["serve"] = phase_serve(dev, cfg, params, **serve)
    infer = launch_counts()                   # ... and ends here
    del params
    empty_cache(dev)
    train = phase_train(dev, train_cfg, B=train_B, S=S)
    empty_cache(dev)
    return fwd, infer, train


def pipeline_launches(pipe, i):
    """Kernel ``i``'s launches on the pipeline's two schedules (their
    timed path: the first step and the timed ones) and per step, for the
    kernels line."""
    return {f"launches_pipeline_{name}": pipe[name]["launches"][i]
            for name in ("gpipe", "1f1b")} | {
        f"launches_per_pipeline_{name}_step": pipe[name]["per_step"][i]
        for name in ("gpipe", "1f1b")}


def empty_cache(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run() -> int:
    import torch
    from ray_tpu_torch.models import GPTConfig, LlamaConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit("device", torch_name=kind, nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    phase_build()

    errs = phase_kernel(dev)
    bwd_errs = phase_kernel_bwd(dev)
    splash_errs = phase_kernel_splash(dev)

    # GPT-2-small, then LLaMA-125M at bench.py's _llama_point: the same
    # training settings (B=32, S=1024, bf16, flash, remat dots, ce_block 256)
    train_kw = dict(attention="flash", remat=True, remat_policy="dots",
                    ce_block=256)
    cfg = GPTConfig.gpt2_small()
    fwd, infer_launches, train = model_paths(
        dev, cfg, dataclasses.replace(cfg, **train_kw))
    phase_top1_trained(dev, dataclasses.replace(cfg, **train_kw),
                       {k: v for k, v in fwd.items()
                        if k.startswith("bf16_top1")})
    llama_fwd, llama_infer, llama_train = model_paths(
        dev, LlamaConfig.llama_125m(),
        LlamaConfig(max_seq_len=1024, **train_kw))
    for name, launches in (("GPT", infer_launches), ("LLaMA", llama_infer)):
        check(launches[0] > 0 and launches[1:] == (0, 0, 0, 0, 0),
              f"{name} inference path launches {launches}")
    # MoE GPT-2-small (Switch-Base-8's widths: 8 experts of 3072, top-2
    # routing in every layer) at the same training settings.
    moe_cfg = dataclasses.replace(cfg, num_experts=8, **train_kw)
    moe_train = phase_train(dev, moe_cfg, B=32, S=1024)
    empty_cache(dev)
    for name, t in (("GPT", train), ("LLaMA", llama_train),
                    ("MoE GPT", moe_train)):
        check(all(t["launches"][:3]), f"the {name} training path missed a "
              f"kernel")
    phase_dist_single(dev, dataclasses.replace(cfg, **train_kw))
    empty_cache(dev)
    # The pipeline at GPT-2-small: bf16 flash, full remat in the stages, the
    # full-logit head, M = 8 microbatches of 4.
    pipe = phase_pipeline(dev, dataclasses.replace(
        cfg, attention="flash", remat=True, remat_policy="full"))
    check(all(all(r["launches"][:3]) for r in pipe.values()),
          "the pipeline path missed a kernel")

    reset_launch_counts()                     # the autotune path starts
    phase_autotune(dev, cfg)
    tune_launches = launch_counts()           # ... and ends here
    emit("autotune_launches", launches=dict(zip(KERNEL_NAMES,
                                                tune_launches)))
    check(all(tune_launches[3:]), "the autotune path missed a splash kernel")
    torch.cuda.empty_cache()
    phase_splash_grad_check(dev)
    torch.cuda.empty_cache()

    times = phase_kernel_times(dev, *MAIN_CASE[1])
    train_times = phase_kernel_times(dev, *TRAIN_CASE[1])
    emit("kernel_times", inference_call=times, train_call=train_times)
    bwd_times = phase_kernel_bwd_times(dev, *TRAIN_CASE[1])
    splash_times = phase_splash_kernel_times(dev)
    phase_attention_shapes(dev)
    torch.cuda.empty_cache()
    runtime = phase_runtime(dev, dataclasses.replace(
        cfg, dtype=torch.bfloat16, attention="flash"),
        fwd["bf16_flash_max_abs_diff_vs_f32"], smi, fwd["serve"],
        dataclasses.replace(cfg, **train_kw), train["ms"])
    emit("total", seconds=time.monotonic() - _T0)
    pipe_launches = [pipe["gpipe"]["launches"][i] +
                     pipe["1f1b"]["launches"][i] for i in range(3)]
    main_o, main_lse = errs[MAIN_CASE[0]]
    train_errs = bwd_errs[TRAIN_CASE[0]]
    splash_main = splash_errs[SPLASH_MAIN[0]]
    common = {"route": "cuda", "dtype": "bfloat16", "causal": True,
              "card": smi}
    splash_common = {"source": "ray_tpu_torch/csrc/splash_attention.cu",
                     "reached_via": "ray_tpu/autotune/dispatch.py:238",
                     "shape": list(SPLASH_SHAPE), "blocks": [128, 128],
                     **common}
    splash_kernel = ("jax/experimental/pallas/ops/tpu/splash_attention/"
                     "splash_attention_kernel.py")
    print(json.dumps({"kernels": [
        {"name": "flash_fwd", "source": "ray_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "ray_tpu/ops/flash_attention.py:91",
         "launches": infer_launches[0] + train["launches"][0] +
         llama_infer[0] + llama_train["launches"][0] +
         moe_train["launches"][0] + pipe_launches[0] +
         runtime["actor_launches"][0] + runtime["serve_launches"][0] +
         runtime["train_launches"][0] + runtime["data_launches"][0] +
         runtime["tune_launches"][0] + runtime["cluster_launches"][0],
         "launches_inference": infer_launches[0],
         "launches_runtime": runtime["actor_launches"][0],
         "launches_serve": runtime["serve_launches"][0],
         "launches_runtime_train": runtime["train_launches"][0],
         "launches_runtime_data": runtime["data_launches"][0],
         "launches_runtime_tune": runtime["tune_launches"][0],
         "launches_runtime_cluster": runtime["cluster_launches"][0],
         "launches_train": train["launches"][0],
         "launches_llama_inference": llama_infer[0],
         "launches_llama_train": llama_train["launches"][0],
         "launches_moe_train": moe_train["launches"][0],
         "launches_autotune": tune_launches[0],
         "launches_per_forward": fwd["launches_per_forward"],
         "launches_per_llama_forward": llama_fwd["launches_per_forward"],
         "launches_per_train_step": train["per_step"][0],
         "launches_per_llama_train_step": llama_train["per_step"][0],
         "launches_per_moe_train_step": moe_train["per_step"][0],
         **pipeline_launches(pipe, 0),
         "max_abs_err": main_o, "lse_max_abs_err": main_lse,
         "train_call_max_abs_err": errs[TRAIN_CASE[0]][0],
         "train_call_lse_max_abs_err": errs[TRAIN_CASE[0]][1],
         **times, "train_call": train_times,
         "design": FLASH_BF16_DESIGN["fwd"], **common},
        {"name": "flash_bwd_dq", "source": "ray_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "ray_tpu/ops/flash_attention.py:217",
         "launches": train["launches"][1] + llama_train["launches"][1] +
         moe_train["launches"][1] + pipe_launches[1] +
         runtime["train_launches"][1] + runtime["data_launches"][1] +
         runtime["tune_launches"][1],
         "launches_train": train["launches"][1],
         "launches_runtime_train": runtime["train_launches"][1],
         "launches_runtime_data": runtime["data_launches"][1],
         "launches_runtime_tune": runtime["tune_launches"][1],
         "launches_llama_train": llama_train["launches"][1],
         "launches_moe_train": moe_train["launches"][1],
         "launches_llama_inference": llama_infer[1],
         "launches_autotune": tune_launches[1],
         "launches_per_train_step": train["per_step"][1],
         "launches_per_moe_train_step": moe_train["per_step"][1],
         **pipeline_launches(pipe, 1),
         "max_abs_err": train_errs["dq"],
         **bwd_times["dq"], "library_covers": "dq+dk+dv",
         "design": FLASH_BF16_DESIGN["dq"], "shape": list(TRAIN_CASE[1]),
         **common},
        {"name": "flash_bwd_dkv", "source": "ray_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "ray_tpu/ops/flash_attention.py:263",
         "launches": train["launches"][2] + llama_train["launches"][2] +
         moe_train["launches"][2] + pipe_launches[2] +
         runtime["train_launches"][2] + runtime["data_launches"][2] +
         runtime["tune_launches"][2],
         "launches_train": train["launches"][2],
         "launches_runtime_train": runtime["train_launches"][2],
         "launches_runtime_data": runtime["data_launches"][2],
         "launches_runtime_tune": runtime["tune_launches"][2],
         "launches_llama_train": llama_train["launches"][2],
         "launches_moe_train": moe_train["launches"][2],
         "launches_llama_inference": llama_infer[2],
         "launches_autotune": tune_launches[2],
         "launches_per_train_step": train["per_step"][2],
         "launches_per_moe_train_step": moe_train["per_step"][2],
         **pipeline_launches(pipe, 2),
         "max_abs_err": max(train_errs["dk"], train_errs["dv"]),
         **bwd_times["dkv"], "library_covers": "dq+dk+dv",
         "design": FLASH_BF16_DESIGN["dkv"], "shape": list(TRAIN_CASE[1]),
         **common},
        {"name": "splash_fwd", "replaces": f"{splash_kernel}:696",
         "launches": tune_launches[3], "max_abs_err": splash_main["o"],
         "lse_max_abs_err": splash_main["lse"], **splash_times["fwd"],
         **splash_common},
        {"name": "splash_bwd_dq", "replaces": f"{splash_kernel}:1307",
         "launches": tune_launches[4], "max_abs_err": splash_main["dq"],
         **splash_times["dq"], "library_covers": "dq+dk+dv",
         **splash_common},
        {"name": "splash_bwd_dkv", "replaces": f"{splash_kernel}:1669",
         "launches": tune_launches[5],
         "max_abs_err": max(splash_main["dk"], splash_main["dv"]),
         **splash_times["dkv"], "library_covers": "dq+dk+dv",
         **splash_common},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
