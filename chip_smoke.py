"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``deer_vla_tpu_torch/csrc/`` and counts
the tensor-core instructions (HMMA / HGMMA) in the SASS of the bf16 K1-K4
kernels and of K1's bf16 backward (which must have no atomics), and K3 /
K4's type conversions, holds each kernel against its
plain PyTorch version at the shapes the serving step gives it (K1 flash
attention, also on the ViT's strided views of a fused qkv and at ragged and
other head-dim shapes; K2 / K3 / K4 the bf16 / int8 / int4 layer-indexed
matmuls, each also for bit-identical repeat launches, under CUDA-graph
replay with a changing device-side layer index, and in each of its three
block configs at 32-256 rows, timed side by side), then serves ``deer_3b``
at full width (24-layer ViT-L/14, 6-layer
perceiver, 12-layer d_model-2048 MPT) from seeded random weights: 8
single-stream steps and 4 eight-stream batched steps with per-stream
dynamic exits, in bf16 and quantized to int8 and int4 (the decoder through
K3 / K4), and 4 eight-stream steps in each w8a8 mode.  Last, one full-depth
step is compared with the same weights run in fp32 on the CPU through the
plain versions, unquantized and (after checking that the card and the CPU
quantize to the same bits) in int8 and int4, the quantized ones and every
later deer_3b cross-check against the CPU (variants, heads, the train
step) on the draw's first ``CROSS_DEPTH`` = 4 decoder and
``CROSS_VIT_DEPTH`` = 8 ViT layers.  Then the evaluation
path:
deer_3b calibration (2 debug batches of 2 trajectories, W=12: 48 ViT
images through K1 a batch) in both regimes, its fp32 forward and deltas on
the card against the CPU at W=2, and ``cli/eval`` run in-process
(calibrate, then DebugEnv rollouts of 2 sequences: bf16 sequential and over
2 lanes, int8 and int4 sequential) with K1-K4 counted.  Then training:
one fp32 deer_3b train step (B=1, W=2, 4 layers) on the card against the
CPU, the same step with ``--unfreeze_vit`` under a 2-layer decoder and the
ViT's first 8 layers (the ViT trained through K1's backward, card against
CPU), ``cli/train --debug`` in-process (deer_3b, batch 6, W=12: 1
joint and 1 exit-only epoch of 4 steps, 144 ViT images a step through K1,
K2-K4 not launched; frozen leaves bit-unchanged, trained leaves moved) and
``cli/eval --evaluate_from_checkpoint`` on its checkpoint.  Then the CALVIN
phases on a CALVIN-format tree written at CALVIN's frame sizes (200 px
static, 84 px gripper; half the episodes DEFLATE-compressed): the native
npz reader against ``np.load`` bit for bit and both timed, with the
loader's batches a second (``calvin_data``); ``cli/train --calvin_dataset``
at JAX's defaults (B=6, W=12, rgb_pad 10, gripper_pad 4), 1 joint and 1
exit-only epoch of 4 batches, one checkpoint (``train_calvin``); ``--dif_ws``
at W=24 (288 ViT images a step, 4 decoder layers) without remat, with
``--remat`` and with
``--remat_policy dots``, losses against each other and peak memory
(``train_calvin_difws``); ``cli/eval --calvin_dataset`` on that checkpoint,
which calibrates on the validation split, writes the values sidecar and
ends with the dropped-env SystemExit, then ``cli/eval --debug`` serving
those values (``calib_calvin``).  The serving variants run between the
serve cross-checks and calibration: the host-bucketed ``DeerPolicy`` (8 B=1
steps, each held against ``ScanDeerPolicy`` with the same products from the
same carry: equal exits), the vision caches on both engines and the action
cache (hits counted, every step equal to the uncached step),
``BatchedDeerPolicy`` at B=8 against ``ScanDeerPolicy.step_batch``,
``fused_3b`` (the cond-chain oracle ``FusedDeerPolicy`` at full depth, 8
B=1 steps under the first-exit, last-exit and a data-dependent row placed
between measured deltas: exits equal to ``ScanDeerPolicy``'s at every
step, actions within CROSS_TOL_BF16, K1 only, median step time), and
ToMe (r = 8) at B=1 / B=8 plus a full-depth step against fp32 on the CPU
with the merges compared layer by layer; the rollouts add one ``cli/eval``
run per serving option (``ROLLOUT_RUNS``; the pipelined lanes' report must
equal ``--lanes 4``'s, and phase ``pipeline`` records its asynchronous
dispatches: the medians for ``dispatch_batch`` to return, ``finish_batch``
to wait and the step, the share of dispatches that returned before their
decode ended, which must be most, the rollout's seconds beside
``--lanes 4``'s, and whether a host read on the card releases the GIL)
and ``--layerwise_exit_eval`` on the trained checkpoint.  Right after the
build, ``compile_cache`` starts a child process with DEER_COMPILE_CACHE
naming a fresh directory that holds a copy of the built library and no
nvcc on PATH or CUDA_HOME, collected after the kernel phases: it must
load that library, build nothing, and launch K2 from it.  K1 is checked at the ViT batch of every driven path
(``vit_batches``), at the ToMe lengths with their bias too, and every shape
the models hand K1 while the paths run is recorded and must be one of those
checked.  The vision, state and window variants run on the same deer_3b draw
with their own leaves (``variant_weights``): ``serve_variants`` (use_state,
pre, two_way, sep_resampler, gripper_res 84 and multi_step_action 3 at B=1 /
B=8 beside the post medians; use_state also in int8 through K3 and through
``DeerPolicy`` against the scan engine), ``cross_check_variants``
(vit_concat + use_state and gripper_res 84, a full-depth bf16 step against
fp32 on the CPU), ``serve_folded`` (vit_concat and use_hist at W=12: the
frame cache against the uncached step, equal exits and arm actions within
2e-4, then B=8), ``calibrate_variants`` (state in both regimes, vit_concat
with ``--calib_warm 2``) and ``train_variants`` (``cli/train --use_state
--fusion_mode vit_concat``, one joint epoch of 4 batches, then ``cli/eval
--frame_cache`` on its checkpoint, in ``build/chip_smoke_variants/``,
deleted after).  The head families (ROADMAP M10b) run on the same draw with
heads of their own (``head_weights``): ``serve_heads`` (gpt, fc under
vit_concat and diffusion at B=1 / B=8 over a six-decade threshold sweep;
gpt also through ``DeerPolicy`` against the scan engine; the diffusion
model's feature step, its DDIM plan timed with its CUDA launches
profiled, ``DiffusionSamplerPolicy`` DDIM plans and one DDPM plan, timed),
``cross_check_heads`` (gpt
and fc a full-depth bf16 step against fp32 on the CPU; the U-Net and a DDIM
plan on the card against the CPU with the same noise), ``calibrate_heads``
(gpt and diffusion in both regimes, the realized mix on the samples against
its target), three ``cli/eval`` rollouts (``--head_type gpt``, ``diffusion
--diff_steps 10``, the same over 2 lanes) and ``train_heads`` (``cli/train
--head_type diffusion`` and ``gpt``, one joint epoch of 4 batches, then
``cli/eval`` on each checkpoint, in ``build/chip_smoke_heads/``, deleted
after).  Then deer_9b (MPT-7B, d_model 4096, x-attn every 4 layers) at its
preset depth of 12 layers: K2 / K3 / K4 at its four products (K = 4096 /
16384, N up to 16384) first, each layer against the plain version, timed
against the bound and cuBLAS, bit-identical across launches and graph
replays, every block config (``kernels_9b``); then served in every mode
(8 B=1 and 4 B=8 steps), ``DeerPolicy`` against the scan engine, a
step of its first 4 layers against fp32 on the CPU, K3 / K4 against their
plain products in fp32, calibration and ``cli/eval --debug --model
mpt_9b``.  Then weight placement (ROADMAP M15b), four child processes
sharing the card over gloo in one spawn: ``tp_serve_9b`` (deer_9b at full
width and depth, tp=4: each rank draws the whole tree in its turn, keeps
its shards (``shard_params``) and frees it, then serves bf16, int8 and
int4 at B=1 and B=8 through K2 / K3 / K4 on its local stacks; each step's
threshold rows sit a factor 2 from the one-process engine's deltas on the
side that gives a chosen exit, and the exits must equal that engine's, the
actions within CROSS_TOL_BF16, every rank's exits the same) and
``tp_train`` (fsdp=2 x tp=2 at deer_9b's width cut to 2 decoder and 8 ViT
layers, fp32, W=2, two joint-phase steps: the first loss within 1e-5 relative and its
grad_norm within 1e-4 of one process's over the same global batch, the
gathered leaves within tests/test_torch_train_steps.py's update tolerance,
frozen leaves bit-unchanged, a rank's Adam moments of a leaf split on both
axes a quarter of it); ``kernels_9b`` holds K2-K4 at one rank's local
stacks (``deer_9b_tp4``) too.
Then bc_llama (the llama decoder, d_model 4096, 32 layers) in bf16 and
int8 (K2-K4 never launch: they compute the MPT block's products), a
bf16 step against fp32 on the card, and ``cli/eval --debug --model
llama_9b``.  Every K2-K4 shape the driven paths launch must be one a
phase checked (``k2_shapes``).  A line before the kernels line gives the
script's total seconds.

The serving artifact (ROADMAP M14b) runs right after the serve phases, on
their draw: ``export_3b`` (eight child processes of this script at once
trace and save deer_3b at 2 ViT and 4 decoder layers, full width, in bf16,
int8 and int4 at B=1 and B=8 (``serving/export.export_policy``, K1-K4 as
``deer::`` operator nodes), and deer_tiny traced on the CPU and on the
card; then each artifact is loaded (``ExportedScanPolicy``) against the
serve draw cut to that depth and served 8 steps beside the live engine:
exits identical, actions, carries and hidden states bit-equal, at least two
exit layers, the same K1-K4 launches, every launch's shape recorded for
``k1_shapes`` / ``k2_shapes`` as the live engine's are (each wrapper's
``observer``: ``k1_calls``, ``k2_calls``); the int4 B=1 artifact also as a bundle
through ``BundledScanPolicy``; deer_tiny traced on the CPU takes the card
trace's exits on the card, and its fp32 K2 shapes are held against the
plain version).

Deployment (ROADMAP M14, M9b) runs on the same deer_3b draw after
calibration: ``serve_http`` (``make_server`` on 127.0.0.1 around
``DeerActionServer``: 4 client threads, a stream each with a threshold
override of its own (first exit, last exit, the calibrated row), 6 steps of
random 200 px and 84 px uint8 frames each, every action and exit layer
bit-equal to a local ``CalvinPolicyAdapter`` on its own view of the engine;
in bf16 and in int8, where K3 launches and K2 does not; healthz and a 400),
``serve_http_batched`` (``BatchedActionServer`` at 8 lanes and a 5 ms
window: 6 concurrent streams and 2 parked ones, each lane bit-equal to
``step_batch`` of a copy of the engine, the parked carries restored bit for
bit; actions/s, dispatches, lanes a dispatch and wasted layers recorded),
``serve_http_diffusion`` (2 streams x 3 DDIM plans bit-equal to a local
sampler) and ``serve_http_batched_vit_concat_state`` (4 streams x 3 steps
with robot_obs, on the variant draw); after the rollouts ``rollout_tcp``
(``cli/gen_sequences``, then ``cli/eval --tcp_rel --diverse_inst
--annotation_cache``, and the trainer's tcp-frame labels on the card
against the CPU) and, on the training phase's checkpoint and the values
sidecar phase train_eval writes beside it, ``serve_cli`` (``main
--oneshot_healthz`` with --thresholds, ``build_core`` with the sidecar).

The tooling (ROADMAP M17) runs on the training phase's checkpoints before
they are deleted: ``convert_3b`` (the seeded deer_3b tree at 2 layers,
every leaf
given a draw of its own, written as the reference's artifacts in
``build/chip_smoke_convert/``: an open_clip ViT ``.pt``, an HF MPT snapshot
of two ``.safetensors`` shards written by this script, a DeeR delta
``.pth`` with its readout keys and values; then ``cli/convert`` in a
process of its own with another seed, every converted leaf bit-equal to
the written one, the audit at 0 unconsumed keys, and 8 B=1 steps of the
converted tree bit-equal to the written tree's), ``bayes_opt_3b``
(``cli/bayes_opt --parallel 2`` at deer_3b: its initial ``cli/eval`` run,
then 2 GP rounds of 2 candidates, each one batched rollout over 4 lanes;
then ``evaluate_policy_batched(candidates=)`` with the first-exit and the
full-depth rows), ``eval_ckpts`` (``cli/eval_ckpts --debug`` on the last
training checkpoint, bf16 at ratio 0.5 on its values sidecar and
``--quantize int8`` at ratio 1.0 calibrating anew, then both again,
skipped) and ``profiling`` (``Timer(sync_on=)``
against CUDA events around device-bound products and an unsynced
``Timer`` short of them, against the host clock of a served step, a
``trace()`` under ``chiprun_out/chip_smoke/``, ``MetricLogger``'s JSONL).

The vision-language suite (ROADMAP M16a) runs last: ``vl_generate_3b``
(seeded deer_3b with its gates drawn, B=8, 10 new tokens: short VQA
prompts on the recompute engine, then 2-shot interleaved prompts of 114-142
tokens with 3 images a row on the cached and the recompute engine, their
logits at the first decoded positions compared and their tokens' agreement
reported; ms a token, peak memory, the device's busy time),
``vl_blip_base`` (blip_base in bf16 through ``BlipEvalModel``: captions for
8 synthetic 384 px images, a VQA answer scored), ``cli/vl_eval --debug``
(blip_base captions; deer_3b 2-shot VQA with RICES demos) and
``cli/cache_features --debug`` with a ``--cached_features`` run on its
index, and ``vl_cross_check`` (2-layer deer_3b and 2-layer blip_base at
full width, bf16 on the card against fp32 on the CPU).  Phase ``k1_vl``
then holds K1 against its plain version on the inputs of every K1 call
key these phases ran that no earlier phase checked (BLIP's 577-token ViT,
the decoder's buffers with their ALiBi bias, the cross-attention with its
media mask), timed beside its plain version and SDPA.

VL pretraining, co-training (ROADMAP M16b) and scale-out (M15) come after
the VL suite, their K1 calls kept for ``k1_vl`` too: ``pretrain_3b``
(``cli/pretrain --debug`` at deer_3b's 12 layers, LAION B=8 and MMC4 B=4 at
224 px taking turns, 4 steps, MMC4 at its default 256 tokens, so the
decoder's self- and cross-attention train through K1 and its backward;
frozen leaves bit-unchanged), ``cotrain_3b``
(``cli/train --debug --cotrain`` at 4 decoder layers on that LAION shard,
4 steps), ``pretrain_cross_check`` (the LM loss and its trainable
gradients on a 2-layer deer_3b, bf16 on the card against fp32 on the CPU),
``scale_out_serve`` (two child processes of this script sharing the card
over gloo: ``ShardedBatchedPolicy`` at B=8, 4 streams a rank, 4 bf16 steps
and an int8 one, the merged exits equal to the single-process step's) and
``scale_out_train`` (two-process ``cli/train --coordinator --debug`` at 2
decoder layers, 2 trajectories a rank: the ranks' trainable leaves
bit-equal, rank 0 alone wrote the checkpoint, the first loss one
process's over the 4 trajectories).  A child's K1 and K2-K4 shapes join
the checks; a child that fails fails the script.  Last, ``k1_backward``
holds K1's backward (``csrc/flash_attention_bwd.cu``: in bf16 the
tensor-core dQ and dK / dV kernels reading the forward's saved row
statistics) against its plain version at every shape the paths ran it on
(their last inputs kept, the forward's statistics with them) and at a
synthetic bf16 ViT call (``split_heads`` views of one fused qkv, q (4, 16,
257, 64), no bias: what a bf16 ``--unfreeze_vit`` run gives it); checks
that the forward with statistics gives the output of the forward without,
bit for bit, and statistics within K1_TOL of the plain ones, and that two
launches of the backward agree bit for bit; timed beside the plain version
and SDPA's backward.

Every phase prints one JSON line, with ``t_s`` the seconds since the
script started; any failed check raises and the script
exits non-zero.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the port's package beside this file, it
exits non-zero and prints no result.  Compiler logs go to
``chiprun_out/chip_smoke/``; the training run's checkpoints go to
``build/chip_smoke_train/`` and the CALVIN tree and its run to
``build/chip_smoke_calvin/``; both are deleted at the end.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "chiprun_out" / "chip_smoke"
SEED = 0
T_START = time.perf_counter()

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# K1 tolerances: fp32 sums in another order than the plain version; in bf16
# P is rounded against the running (not the final) row max and the output
# is rounded to bf16, about 2^-8 relative, on outputs of unit scale.
K1_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# K2 tolerances, relative to max|y|: both sides round an fp32 sum to the
# output dtype, in different summation orders (bf16: two ulps).
K2_REL_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}

# the bf16 kernels redesigned for the tensor cores, by SASS function name:
# a function belongs to a kernel if its mangled name holds every word of
# one of the kernel's entries
TENSOR_CORE_KERNELS = {
    "flash_attention": (("flash_attention_bf16",),),
    "indexed_matmul": (("indexed_matmul_bf16",), ("indexed_matmul_wgmma",)),
    "indexed_matmul_q8": (("indexed_matmul_quant_mma", "Int8Codes"),
                          ("indexed_matmul_quant_wgmma", "Int8Codes")),
    "indexed_matmul_q4": (("indexed_matmul_quant_mma", "Int4Codes"),
                          ("indexed_matmul_quant_wgmma", "Int4Codes")),
    "flash_attention_backward": (("attn_bwd_dq",), ("attn_bwd_dkdv",))}
# SASS type conversions (integer <-> float, float <-> float)
CONVERSION = re.compile(r"\b(?:I2F|I2FP|F2F|F2FP|F2I|I2I)\b")
# SASS atomics (global and shared): K1's backward must have none, so that
# two launches give the same bits
ATOMIC = re.compile(r"\b(?:ATOM|ATOMG|ATOMS|RED|REDG)\b")

# The step at deer_3b: full depth on the card in bf16 against fp32 on the
# CPU.  bf16 keeps 8 bits of mantissa through 24 + 12 residual layers.
CROSS_TOL_BF16 = {"arm_max_abs": 5e-2, "hidden_rel_l2": 5e-2}
# The same step with fp32 compute on the card (both kernels' fp32 paths):
# only the summation order differs.
CROSS_TOL_FP32 = {"arm_max_abs": 1e-3, "hidden_rel_l2": 1e-3}

# ToMe: patch tokens merged a ViT layer in the ToMe phases (--vit_tome_r)
TOME_R = 8
# the cli/eval rollout phases: (phase, flags after ROLLOUT_ARGV)
ROLLOUT_RUNS = (
    ("rollout", []), ("rollout_lanes2", ["--lanes", "2"]),
    ("rollout_int8", ["--quantize", "int8"]),
    ("rollout_int4", ["--quantize", "int4"]),
    ("rollout_bucketed", ["--engine", "bucketed"]),
    ("rollout_exit_id5", ["--exit_id", "5"]),
    ("rollout_bucketed_ensemble", ["--engine", "bucketed",
                                   "--use_action_ensemble"]),
    ("rollout_bucketed_multi_execution2", ["--engine", "bucketed",
                                           "--multi_execution", "2"]),
    ("rollout_tome8", ["--vit_tome_r", str(TOME_R)]),
    ("rollout_vision_cache_scan", ["--vision_cache_tau", "0.05"]),
    ("rollout_vision_cache_bucketed", ["--engine", "bucketed",
                                       "--vision_cache_tau", "0.05"]),
    ("rollout_action_cache", ["--action_cache_tau", "0.03"]),
    ("rollout_bucketed_int8", ["--engine", "bucketed", "--quantize",
                               "int8"]),
    ("rollout_lanes4", ["--lanes", "4"]),
    ("rollout_lanes4_pipeline2", ["--lanes", "4", "--pipeline", "2",
                                  "--env_workers", "2"]))
# the rollout report entries that --pipeline / --env_workers must not move
PIPELINE_SAME = ("avg_seq_len", "chain_sr", "success_exit_hist",
                 "fail_exit_hist", "avg_exit_layer", "task_info")
# the thresholds the serve phases sweep, one a step (a stream at B=8), over
# three decades: with these random heads the exit deltas lie around 1e-5
# (the first full run), so the dynamic exit has room to pick different
# layers
SWEEP = [10.0 ** (-6 + 3 * s / 7) for s in range(8)]
# DeerPolicy against ScanDeerPolicy with the same bf16 products (cuBLAS, no
# K2) on the same weights, inputs, thresholds and carry: the same layers in
# the same order, so the exits must be equal; the actions (tanh outputs in
# [-1, 1]) are held to 1e-2, a few bf16 ulps of a unit value
BUCKETED_TOL = {"arm_max_abs": 1e-2}
# the ToMe step at full depth against fp32 on the CPU: on the card in fp32
# only the summation order differs (CROSS_TOL_FP32, and every merge must
# agree).  In bf16 pairs whose similarities lie within bf16 rounding of each
# other merge otherwise than in fp32 (from the second merging layer on, in
# the first run on an H100), which moves whole tokens of the perceiver's
# input, and after the first such layer the token order differs too; the
# actions are held to the exact step's tolerance, the hidden state and the
# merges are reported
TOME_TOL_BF16 = {"arm_max_abs": 5e-2}
# the window of the fp32 calibration cross-check (one trajectory)
CALIB_CROSS_WINDOW = 2
# the training phases: cli/train's default batch (trajectories of W=12),
# 1 joint and 1 exit-only epoch of the DebugBatcher's 4 batches; a warmup
# of 1 step (2500 would keep every update below fp32 resolution)
TRAIN_BATCH = 6
TRAIN_DIR = REPO / "build" / "chip_smoke_train"
TRAIN_ARGV = ["--debug", "--model", "mpt_dolly_3b", "--batch_size_calvin",
              str(TRAIN_BATCH), "--num_joint_epochs", "1",
              "--num_exit_epochs", "1", "--joint_warmup_steps", "1",
              "--exit_warmup_steps", "1", "--logging_steps", "1",
              "--from_scratch", "--run_name", str(TRAIN_DIR)]
TRAIN_STEPS = 8
VIT_LAYERS = 24
# the fp32 train step, card against CPU (B=1, W=2, the window of
# CALIB_CROSS_WINDOW): the loss and the gradients differ only by summation
# order; Adam divides a gradient by its own size, so an updated param is
# held to 1e-5 of its norm plus the gradient's tolerance times the norm of
# its update (a zero-initialized bias is all update after one step)
TRAIN_TOL_FP32 = {"loss_rel": 1e-5, "grad_rel_l2": 1e-3,
                  "param_rel_l2": 1e-5}
# the CALVIN phases: a CALVIN-format tree at CALVIN's frame sizes (200 px
# static, 84 px gripper, CALVIN's keys), every other episode written with
# savez_compressed; training/ 6 x 64 frames (about 55 MB), validation/
# 2 x 40
CALVIN_DIR = REPO / "build" / "chip_smoke_calvin"
CALVIN_RUN = CALVIN_DIR / "run"
CALVIN_SPLITS = {"training": (6, 64), "validation": (2, 40)}
CALVIN_KEYS = ("rgb_static", "rgb_gripper", "rel_actions", "robot_obs",
               "scene_obs")
# cli/train on it at JAX's defaults (B=6, W=12, rgb_pad 10, gripper_pad 4);
# --data_percent 0.08 keeps 24 of the 312 windows: 4 batches an epoch
CALVIN_TRAIN_ARGV = ["--model", "mpt_dolly_3b", "--calvin_dataset",
                     str(CALVIN_DIR), "--batch_size_calvin", str(TRAIN_BATCH),
                     "--num_joint_epochs", "1", "--num_exit_epochs", "1",
                     "--joint_warmup_steps", "1", "--exit_warmup_steps", "1",
                     "--logging_steps", "1", "--data_percent", "0.08",
                     "--from_scratch", "--run_name", str(CALVIN_RUN)]
# --dif_ws at W=24: 1 joint epoch of 5 batches (31 of 312 windows), one
# loader thread so the window draws come in the same order in every run
DIFWS_ARGV = ["--model", "mpt_dolly_3b", "--calvin_dataset", str(CALVIN_DIR),
              "--batch_size_calvin", str(TRAIN_BATCH), "--dif_ws",
              "--window_size", "24", "--max_window_size", "24",
              "--num_joint_epochs", "1", "--num_exit_epochs", "0",
              "--joint_warmup_steps", "1", "--logging_steps", "1",
              "--data_percent", "0.1", "--workers", "1", "--from_scratch",
              # 4 decoder layers: the ViT's 288 images a step are the same
              "--max_layer", "4",
              "--run_name", str(CALVIN_DIR / "run_difws")]
DIFWS_STEPS = 5
DIFWS_RUNS = (("none", []), ("full", ["--remat"]),
              ("dots", ["--remat", "--remat_policy", "dots"]))
# the same seeds, batches and draws with and without remat: the forward is
# the same computation, the gradients differ by the order of atomic sums,
# so a loss after an update moves by bf16 noise; held to 1e-2 relative
# (2.56 bf16 ulps)
DIFWS_LOSS_REL = 1e-2


def released_gb(torch) -> float:
    """Frees what earlier phases left to the garbage collector (an
    exception's traceback cycle can hold a step's tensors) and returns the
    device memory still allocated, in GB."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 1e9


def emit(obj) -> None:
    """One JSON line; a phase's line also gets ``t_s``, the seconds since
    the script started, so that each phase's share of the time limit can
    be read off the output."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Time of one call from CUDA events around ``iters`` eager calls: the
    device time, or the host's time to issue a call where that is longer."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int, replays: int = 5) -> float:
    """Device time of one call: ``iters`` calls captured once in a CUDA
    graph (after two warm-up calls on a side stream) and replayed
    ``replays`` times between CUDA events, so the host's cost of issuing
    each call is not in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def bound(nbytes: int, flops: int, dtype: str) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


# what phase_device read: "smi", the card's name and power limit
DEVICE = {}


def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    DEVICE["smi"] = smi
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": False})
    return smi


def sass_counts(lib_path, out_dir=None) -> dict:
    """Per kernel function in the library's SASS (``cuobjdump -sass``, next
    to nvcc): its HMMA / HGMMA instructions, its type conversions and its
    atomics."""
    from deer_vla_tpu_torch.ops.kernels import build
    cuobjdump = Path(build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    if out_dir is not None:
        (out_dir / "kernels.sass").write_text(sass)
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = line.split("Function :", 1)[1].strip()
            counts.setdefault(current, {"tensor_core": 0, "conversions": 0,
                                        "atomics": 0})
        elif current is not None:
            if "HMMA" in line or "HGMMA" in line:
                counts[current]["tensor_core"] += 1
            if CONVERSION.search(line):
                counts[current]["conversions"] += 1
            if ATOMIC.search(line):
                counts[current]["atomics"] += 1
    return counts


def kernel_sass(counts: dict, entries) -> dict:
    """The functions of one kernel (``TENSOR_CORE_KERNELS`` entries) and
    their summed counts."""
    per_fn = {name: c for name, c in counts.items()
              if any(all(word in name for word in e) for e in entries)}
    return {"instances": len(per_fn),
            "hmma_hgmma": sum(c["tensor_core"] for c in per_fn.values()),
            "conversions": sum(c["conversions"] for c in per_fn.values()),
            "atomics": sum(c["atomics"] for c in per_fn.values()),
            "per_instance": per_fn}


def start_build():
    """The kernels' nvcc build (``build.build_library``) in a thread, so
    that it runs while the device starts up; ``phase_build`` joins it."""
    import threading
    from deer_vla_tpu_torch.ops.kernels import build
    failed = []

    def run():
        try:
            build.build_library()
        except Exception as e:  # raised again by phase_build's own call
            failed.append(e)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread


def phase_build(builder=None) -> dict:
    from deer_vla_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    if builder is not None:
        builder.join()
    build.library()
    info = build.build_info()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "build_log.txt").write_text(info["log"])
    usage = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln]
    counts = sass_counts(build.build_library(), OUT_DIR)
    tc = {}
    for kernel, entries in TENSOR_CORE_KERNELS.items():
        tc[kernel] = kernel_sass(counts, entries)
        per_fn = tc[kernel]["per_instance"]
        check(bool(per_fn) and all(c["tensor_core"] for c in per_fn.values()),
              f"{kernel}: no tensor-core instructions in {per_fn}")
    check(tc["flash_attention_backward"]["atomics"] == 0,
          f"K1's backward has atomics: {tc['flash_attention_backward']}")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": info["seconds"], "ptxas": usage,
          "tensor_core_sass": tc})
    return tc


COMPILE_CACHE_DIR = REPO / "build" / "chip_smoke_compile_cache"


def child_compile_cache(torch, cache: str) -> dict:
    """The compile-cache child: no nvcc on PATH or CUDA_HOME and
    DEER_COMPILE_CACHE naming ``cache``, which holds a copy of the
    parent's library.  A main wrapped in ``utils/errors.record`` (as every
    CLI main is) launches K2 once; the library must come from ``cache``,
    with no build."""
    from deer_vla_tpu_torch.ops.kernels import build
    from deer_vla_tpu_torch.ops.kernels.indexed_matmul import indexed_matmul
    from deer_vla_tpu_torch.utils.errors import record
    try:
        nvcc = build.find_nvcc()
    except RuntimeError:
        nvcc = None
    check(nvcc is None, f"compile_cache child: nvcc reachable at {nvcc}")

    @record
    def main():
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        x = torch.randn(64, 256, generator=gen, device="cuda").bfloat16()
        w = torch.randn(2, 256, 128, generator=gen, device="cuda").bfloat16()
        idx = torch.ones((), dtype=torch.int32, device="cuda")
        y = indexed_matmul(x, w, idx).float()
        ref = x.float() @ w[1].float()
        return float((y - ref).abs().max() / ref.abs().max())

    rel = main()
    info = build.build_info()
    want = Path(cache).resolve()
    check(info["dir"] == str(want)
          and info["library"] == str(want / build.library_name())
          and info["seconds"] == 0.0,
          f"compile_cache child: build_info {dict(info, log=None)}")
    check(rel < 1e-2, f"compile_cache child: K2 off by {rel} relative")
    return {"dir": info["dir"], "library": info["library"],
            "build_seconds": info["seconds"], "k2_rel_err": rel}


def start_compile_cache() -> dict:
    """Starts the compile-cache child (``--child compile_cache``): a fresh
    DEER_COMPILE_CACHE directory holding a copy of the library this run
    built, and no nvcc on PATH or CUDA_HOME (``child_compile_cache``).  It
    runs while the kernel phases do; ``phase_compile_cache`` collects
    it."""
    import os
    from deer_vla_tpu_torch.ops.kernels import build
    shutil.rmtree(COMPILE_CACHE_DIR, ignore_errors=True)
    COMPILE_CACHE_DIR.mkdir(parents=True)
    lib = build.build_library()  # built by phase_build: only looked up
    shutil.copy2(lib, COMPILE_CACHE_DIR / lib.name)
    path = [d for d in os.environ.get("PATH", "").split(os.pathsep)
            if d and not (Path(d) / "nvcc").exists()]
    env = dict(os.environ, DEER_COMPILE_CACHE=str(COMPILE_CACHE_DIR),
               CUDA_HOME=str(COMPILE_CACHE_DIR / "no_cuda"),
               PATH=os.pathsep.join(path))
    started = start_children("compile_cache", 1, str(COMPILE_CACHE_DIR), env)
    started.update(t0=time.perf_counter(), library=lib.name)
    return started


def phase_compile_cache(started: dict) -> dict:
    """DEER_COMPILE_CACHE on the card: the child started by
    ``start_compile_cache`` loaded the copied library from the cache
    directory, built nothing, and launched K2 from it."""
    try:
        res = wait_children(started, timeout_s=180)[0]
    finally:
        shutil.rmtree(COMPILE_CACHE_DIR, ignore_errors=True)
    out = {"phase": "compile_cache",
           "seconds": time.perf_counter() - started["t0"],
           "copied": started["library"], "child_dir": res["dir"],
           "child_library": res["library"],
           "child_build_seconds": res["build_seconds"],
           "child_k2_rel_err": res["k2_rel_err"]}
    emit(out)
    return out


def k1_times(torch, q, k, v, scale) -> dict:
    """K1 without bias, its plain version and SDPA on the same q, k, v:
    device time of one call from CUDA-graph replays, and K1's eager time."""
    from deer_vla_tpu_torch.ops.kernels.flash_attention import (
        flash_attention, flash_attention_reference)
    F = torch.nn.functional
    return {"kernel_ms": graph_ms(
                torch, lambda: flash_attention(q, k, v, None, scale), 48),
            "kernel_eager_ms": time_ms(
                torch, lambda: flash_attention(q, k, v, None, scale), 48),
            "reference_ms": graph_ms(
                torch, lambda: flash_attention_reference(q, k, v, None,
                                                         scale), 12),
            "library_ms": graph_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, scale=scale), 48)}


def k1_cases(torch):
    """(name, q, k, v, bias, scale) at the shapes the port gives K1."""
    from deer_vla_tpu_torch.ops.alibi import full_attn_bias
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    cases = []
    for streams in (1, 8):
        for dt in (torch.bfloat16, torch.float32):
            shape = (2 * streams, 16, 257, 64)  # both cameras, one batch
            cases.append((f"vit_b{streams}_{str(dt)[6:]}", rand(*shape, dtype=dt),
                          rand(*shape, dtype=dt), rand(*shape, dtype=dt), None,
                          0.125))
    mask = torch.ones(2, 32, dtype=torch.int64, device="cuda")
    mask[1, 24:] = 0
    alibi = full_attn_bias(mask, 16, 32, 8.0, torch.bfloat16)
    bf = torch.bfloat16
    cases.append(("alibi_causal_b2h16_s32", rand(2, 16, 32, 128, dtype=bf),
                  rand(2, 16, 32, 128, dtype=bf),
                  rand(2, 16, 32, 128, dtype=bf), alibi, 128 ** -0.5))
    # cross-attention layout: (B, 1, 32, 128) bias broadcast over heads;
    # text rows before the media token are -1e9 everywhere
    xbias = torch.zeros(2, 1, 32, 128, device="cuda")
    xbias[:, :, :, 64:] = -1e9
    xbias[:, :, :3, :] = -1e9
    for dt in (torch.bfloat16, torch.float32):
        cases.append((f"xattn_bcast_masked_rows_{str(dt)[6:]}",
                      rand(2, 8, 32, 64, dtype=dt),
                      rand(2, 8, 128, 64, dtype=dt),
                      rand(2, 8, 128, 64, dtype=dt), xbias, 0.125))
    # ragged q and k tiles with a bias broadcast over heads; head dims the
    # bf16 kernel zero-pads (16: deer_tiny, and 48 to 64; 96 to 128)
    rbias = rand(3, 1, 100, 79, dtype=torch.float32) * 2
    cases.append(("ragged_sq100_sk79_bcast_bias_bfloat16",
                  rand(3, 4, 100, 64, dtype=bf), rand(3, 4, 79, 64, dtype=bf),
                  rand(3, 4, 79, 64, dtype=bf), rbias, 0.125))
    for d, sq in ((16, 130), (48, 70), (96, 129)):
        cases.append((f"d{d}_s{sq}_bfloat16", rand(2, 2, sq, d, dtype=bf),
                      rand(2, 2, sq, d, dtype=bf), rand(2, 2, sq, d, dtype=bf),
                      None, d ** -0.5))
    return cases


def rollout_streams() -> set:
    """The streams a dispatch of each cli/eval rollout phase hands the ViT:
    1 sequentially, the lanes over the pipeline's groups with --lanes."""
    from deer_vla_tpu_torch.cli import eval as cli
    out = set()
    for _, flags in ROLLOUT_RUNS + HEAD_ROLLOUTS:
        args = cli.build_parser().parse_args(ROLLOUT_ARGV + flags)
        groups = max(1, min(args.pipeline, args.lanes))
        while args.lanes % groups:
            groups -= 1
        out.add(max(args.lanes, 1) // groups)
    return out


def vit_batches(cfg) -> dict:
    """The ViT batches, in streams (a stream is both cameras' frames), that
    the paths this script drives hand K1, by compute dtype: the serve
    phases' B=1 and B=8, each rollout's dispatch, a calibration batch's B*W
    frames (phase calibrate and ``cli/eval``), a training batch's B*W
    frames, the window-folded variants' W frames at B=1 and B=8, a
    ``cli/bayes_opt --parallel`` round's lanes (``BO_LANES``); in fp32
    the serve cross-checks' B=1, the calibration and training
    cross-checks' W frames and the folded cross-check's W frames.
    ``images`` holds the one-camera passes, in images.  ``tome`` holds the batches the ToMe
    tower runs at: phase serve_tome's B=1 and B=8 and its fp32 cross-check,
    and the ToMe rollout's calibration and serving."""
    from deer_vla_tpu_torch.cli.eval import CALIB_BATCH_SIZE
    calib = CALIB_BATCH_SIZE * cfg.window_size
    train = TRAIN_BATCH * cfg.window_size  # also a CALVIN calibration batch
    difws = TRAIN_BATCH * int(DIFWS_ARGV[DIFWS_ARGV.index("--window_size")
                                         + 1])
    # the window-folded variants' uncached steps: W frames a stream
    folded = cfg.window_size
    return {"bfloat16": sorted({1, 8, calib, train, difws, folded,
                                8 * folded, BO_LANES, *rollout_streams()}),
            # tp_train's one-process reference: its global batch's frames
            "float32": sorted({1, CALIB_CROSS_WINDOW, folded,
                               TP_TRAIN_BATCH * CALIB_CROSS_WINDOW}),
            "calib": calib, "train": train, "difws": difws,
            "folded": folded,
            # one-camera passes (two_way, sep_resampler, the static camera
            # beside a native-size gripper) at B=1 and B=8, in images
            "images": {"bfloat16": [1, 8], "float32": [1]},
            "tome": {"bfloat16": [1, 8, calib], "float32": [1]}}


def k1_key(q, k, bias) -> tuple:
    """What tells two K1 calls apart for its checks: q's shape, the key
    length, the dtype, whether q is a strided view, the bias shape."""
    return (tuple(q.shape), k.shape[2], str(q.dtype)[6:], q.is_contiguous(),
            None if bias is None else tuple(bias.shape))


@contextlib.contextmanager
def observed(fn, record):
    """While open, ``record`` is called with the inputs of every launch of
    ``fn``'s kernel (the wrapper's ``observer``, called where it counts the
    launch: the live engine's calls and an exported program's operator
    calls alike), then the observer that was set before."""
    before = fn.observer

    def both(*inputs):
        record(*inputs)
        if before is not None:
            before(*inputs)

    fn.observer = both
    try:
        yield
    finally:
        fn.observer = before


@contextlib.contextmanager
def k1_calls(seen: set, keep: dict = None):
    """While open, adds the ``k1_key`` of every K1 launch to ``seen``, and
    keeps each key's first inputs in ``keep`` when given."""
    from deer_vla_tpu_torch.ops.kernels import flash_attention as fa

    def record(q, k, v, bias, scale):
        key = k1_key(q, k, bias)
        seen.add(key)
        if keep is not None and key not in keep:
            keep[key] = detached(q, k, v, bias) + (scale,)

    with observed(fa.flash_attention, record):
        yield seen


def detached(*ts) -> tuple:
    """``ts`` cut from the autograd graph (``None`` kept), so a kept input
    holds no step's activations alive."""
    return tuple(None if t is None else t.detach() for t in ts)


def snapshot(*ts) -> tuple:
    """Copies of ``ts`` with their strides (``None`` kept), cut from the
    autograd graph: autograd may reuse an upstream gradient's buffer once
    the backward that read it is done."""
    return tuple(None if t is None else
                 t.new_empty_strided(t.shape, t.stride()).copy_(t.detach())
                 for t in ts)


@contextlib.contextmanager
def k1_backward_calls(keep: dict):
    """While open, keeps the last inputs of each ``k1_key`` of every K1
    backward launch (the operator's gradient calls
    ``flash_attention_backward`` with the row statistics its forward
    saved), copied, in ``keep``: the last, because the cross-attention's
    gates start at zero, so its first upstream gradients are all zero."""
    from deer_vla_tpu_torch.ops.kernels import flash_attention as fa

    def record(q, k, v, bias, out, dout, scale, stats):
        keep[k1_key(q, k, bias)] = snapshot(q, k, v, bias, out, dout) \
            + (scale,) + snapshot(stats)

    with observed(fa.flash_attention_backward, record):
        yield keep


@contextlib.contextmanager
def k2_calls(seen: set):
    """While open, adds (kernel, m, k, n, x dtype) of every K2 / K3 / K4
    launch to ``seen``."""
    from deer_vla_tpu_torch.ops.kernels import indexed_matmul as imm

    def record(name):
        def add(x, w):
            seen.add((name, x.numel() // x.shape[-1], x.shape[-1],
                      w.shape[-1], str(x.dtype)[6:]))
        return add

    with contextlib.ExitStack() as stack:
        for name in ("indexed_matmul", "indexed_matmul_q8",
                     "indexed_matmul_q4"):
            stack.enter_context(observed(getattr(imm, name), record(name)))
        yield seen


def vit_strided_qkv(torch, streams: int, dt, images: int = None):
    """q, k, v as the ViT hands them to K1: ``split_heads`` views of one
    fused (2B, 257, 3 * 1024) qkv projection, no copy; ``images`` instead
    of 2B for a one-camera pass."""
    from deer_vla_tpu_torch.ops.attention import split_heads
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7 * streams)
    qkv = torch.randn(images or 2 * streams, 257, 3 * 1024, generator=gen,
                      device="cuda").to(dt)
    q, k, v = (split_heads(t, 16) for t in qkv.chunk(3, dim=-1))
    check(not q.is_contiguous() and q.data_ptr() == qkv.data_ptr(),
          "split_heads did not give a view")
    return q, k, v


def tome_k1_cases(torch, streams: int, dt) -> list:
    """(name, q, k, v, bias, scale) as the ToMe tower at r = TOME_R hands
    them to K1: at layer i >= 1 Sq = Sk = 257 - TOME_R * i, for every i
    whose Sq reaches ``ops.attention.KERNEL_MIN_SQ`` (layer 0 runs before
    any merge, at the exact tower's shape and without a bias);
    ``split_heads`` views of one fused qkv and the (2B, 1, Sq, Sq)
    log-size bias, an expand of one row per image (random merged sizes)."""
    from deer_vla_tpu_torch.ops.attention import KERNEL_MIN_SQ, split_heads
    from deer_vla_tpu_torch.ops.tome import (proportional_attn_bias,
                                             tome_schedule)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11 * streams)
    cases, n = [], 256
    for i, r in enumerate(tome_schedule(n, VIT_LAYERS, TOME_R)):
        sq = n + 1
        if sq < KERNEL_MIN_SQ:
            break
        if i > 0:
            qkv = torch.randn(2 * streams, sq, 3 * 1024, generator=gen,
                              device="cuda").to(dt)
            q, k, v = (split_heads(t, 16) for t in qkv.chunk(3, dim=-1))
            sizes = torch.randint(1, 9, (2 * streams, sq), generator=gen,
                                  device="cuda").float()
            sizes[:, 0] = 1.0  # CLS
            cases.append((f"tome_l{i}_sq{sq}_b{streams}_{str(dt)[6:]}", q,
                          k, v, proportional_attn_bias(sizes, sq), 0.125))
        n -= r
    return cases


def k1_bias_times(torch, q, k, v, bias, scale) -> dict:
    """``k1_times`` with a bias: K1 and its plain version on the expanded
    bias as the ViT gives it, SDPA on the bias cast to q's dtype (its float
    masks take that dtype only)."""
    from deer_vla_tpu_torch.ops.kernels.flash_attention import (
        flash_attention, flash_attention_reference)
    F = torch.nn.functional
    mask = bias.to(q.dtype)
    return {"kernel_ms": graph_ms(
                torch, lambda: flash_attention(q, k, v, bias, scale), 48),
            "kernel_eager_ms": time_ms(
                torch, lambda: flash_attention(q, k, v, bias, scale), 48),
            "reference_ms": graph_ms(
                torch, lambda: flash_attention_reference(q, k, v, bias,
                                                         scale), 12),
            "library_ms": graph_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=scale), 48)}


# a decoder layer's four stacked products (name, K, N), by model: the MPT
# block's fused wqkv, out_proj, mlp_up and mlp_down (12 layers each)
DECODER_PRODUCTS = {
    "deer_3b": (("wqkv", 2048, 6144), ("out_proj", 2048, 2048),
                ("mlp_up", 2048, 8192), ("mlp_down", 8192, 2048)),
    "deer_9b": (("wqkv", 4096, 12288), ("out_proj", 4096, 4096),
                ("mlp_up", 4096, 16384), ("mlp_down", 16384, 4096)),
    # one rank's local stacks of deer_9b at tp=4 (phase tp_serve_9b): the
    # column products' N and the row products' K a quarter
    "deer_9b_tp4": (("wqkv", 4096, 3072), ("out_proj", 1024, 4096),
                    ("mlp_up", 4096, 4096), ("mlp_down", 4096, 4096))}
# (streams, x dtype) of the indexed-matmul cases, by model: M = 32 text rows
# a stream (a text row a frame under use_hist).  deer_9b: the serve phase's B=1 and B=8, and B=1 in fp32 (the
# cross-checks' fp32 steps)
INDEXED_CASES = {
    # 4 streams: --lanes 4 and a cli/bayes_opt round (BO_LANES)
    "deer_3b": ((1, "bfloat16"), (2, "bfloat16"), (4, "bfloat16"),
                (8, "bfloat16"), (32, "bfloat16"), (1, "float32"),
                # use_hist's W=12 text rows a stream at B=1 and B=8
                (12, "bfloat16"), (96, "bfloat16")),
    "deer_9b": ((1, "bfloat16"), (8, "bfloat16"), (1, "float32")),
    "deer_9b_tp4": ((1, "bfloat16"), (8, "bfloat16"))}

# row counts at which each of K2's block configs is checked and timed: 1-4
# and 8 streams (96 rows fill a 128-row block partly)
K2_CONFIG_ROWS = (32, 64, 96, 128, 256)


def k2_cases(torch, streams: int, dt, model: str = "deer_3b"):
    """(name, x, w) for the decoder's four stacked products."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + streams)
    out = []
    for name, k, n in DECODER_PRODUCTS[model]:
        x = torch.randn(32 * streams, k, generator=gen, device="cuda").to(dt)
        w = (torch.randn(12, k, n, generator=gen, device="cuda")
             * k ** -0.5).to(dt)
        out.append((f"{name}_b{streams}_{str(dt)[6:]}", x, w))
    return out


def k2_times(torch, run, plain, library, idxs) -> dict:
    """A layer-indexed product timed cycling through the 12 layers, so each
    call reads a slice the previous call did not, as the decoder loop does
    (a stack of 12 exceeds the 50 MB L2): the kernel, its plain version and
    the library call, device time of one call from CUDA-graph replays, and
    the kernel's eager time.  ``run`` takes the 0-dim int32 layer tensor,
    ``plain`` and ``library`` the layer as an int (a tensor index would sync
    the host each call)."""
    it = iter(range(10 ** 9))
    return {"kernel_ms": graph_ms(torch, lambda: run(idxs[next(it) % 12]), 48),
            "kernel_eager_ms": time_ms(
                torch, lambda: run(idxs[next(it) % 12]), 48),
            "reference_ms": graph_ms(torch, lambda: plain(next(it) % 12), 24),
            "library_ms": graph_ms(torch, lambda: library(next(it) % 12),
                                   48)}


def indexed_case(torch, kernel: str, name: str, x, n: int, nbytes: int,
                 run, plain, library, idxs, checked: set) -> dict:
    """One layer-indexed product: every one of the 12 layers checked
    against the plain version (tolerance relative to max|y|), then timed
    by ``k2_times``; its (kernel, m, k, n, x dtype) joins ``checked``."""
    dts = str(x.dtype)[6:]
    err = 0.0
    scale = 0.0
    for i in range(12):
        got = run(idxs[i])
        ref = plain(idxs[i])
        err = max(err, (got.float() - ref.float()).abs().max().item())
        scale = max(scale, ref.float().abs().max().item())
    tol = K2_REL_TOL[dts] * scale
    check(err <= tol, f"{kernel} {name}: max abs err {err} > {tol}")
    m, kk = x.shape
    checked.add((kernel, m, kk, n, dts))
    row = {"kernel": kernel, "case": name, "m": m, "k": kk, "n": n,
           "layers": 12, "max_abs_err": err, "tolerance": tol}
    row.update(bound(nbytes, 2 * m * kk * n, dts))
    row.update(k2_times(torch, run, plain, library, idxs))
    return row


def layer_summary(rows: list, m: int = 32) -> dict:
    """One decoder layer of the model ``rows`` hold (``DECODER_PRODUCTS``)
    in bf16 at ``m`` rows (32 a stream): the four products' times, bytes
    and operations summed, and their bound."""
    out = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bytes": 0, "flops": 0, "max_abs_err": 0.0}
    for row in rows:
        if row["m"] == m and row["case"].endswith("bfloat16"):
            for key, src in (("ms", "kernel_ms"),
                             ("plain_ms", "reference_ms"),
                             ("library_ms", "library_ms"),
                             ("bytes", "bytes"), ("flops", "flops")):
                out[key] += row[src]
            out["max_abs_err"] = max(out["max_abs_err"], row["max_abs_err"])
    out.update(bound(out["bytes"], out["flops"], "bfloat16"))
    return out


def phase_kernels(torch, vit: dict) -> dict:
    """K1-K4 against their plain versions and timed; ``vit`` is
    ``vit_batches``.  The summary's ``k1_checked`` holds the ``k1_key`` of
    every K1 case checked, its ``k2_checked`` the (kernel, m, k, n, x
    dtype) of every K2-K4 case."""
    from deer_vla_tpu_torch.ops.kernels.flash_attention import (
        flash_attention, flash_attention_reference)
    rows = []
    summary = {}

    from deer_vla_tpu_torch.ops.attention import merge_heads
    from deer_vla_tpu_torch.ops.kernels.flash_attention import TC_HEAD_DIMS
    cases = k1_cases(torch)
    for dts in ("bfloat16", "float32"):
        for streams in vit[dts]:
            q, k, v = vit_strided_qkv(torch, streams, getattr(torch, dts))
            cases.append((f"vit_strided_b{streams}_{dts}", q, k, v, None,
                          0.125))
        for images in vit["images"][dts]:
            q, k, v = vit_strided_qkv(torch, 0, getattr(torch, dts), images)
            cases.append((f"vit_strided_i{images}_{dts}", q, k, v, None,
                          0.125))
    for dts, batches in vit["tome"].items():
        for streams in batches:
            cases += tome_k1_cases(torch, streams, getattr(torch, dts))
    summary["k1_checked"] = set()
    summary["flash_attention_tome"] = []
    summary["flash_attention_tome_calib"] = []
    for name, q, k, v, bias, scale in cases:
        summary["k1_checked"].add(k1_key(q, k, bias))
        dt = str(q.dtype)[6:]
        got = flash_attention(q, k, v, bias, scale)
        if dt == "bfloat16" and q.shape[-1] in TC_HEAD_DIMS:
            # the (B, H, Sq, D) view of a (B, Sq, H, D) buffer: merge_heads
            # is a view of it, no copy
            check(merge_heads(got).data_ptr() == got.data_ptr()
                  and got.transpose(1, 2).is_contiguous(),
                  f"K1 {name}: output is not merge_heads-ready")
        ref = flash_attention_reference(q, k, v, bias, scale)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        check(bool(torch.isfinite(got).all()), f"K1 {name}: non-finite")
        check(err <= K1_TOL[dt], f"K1 {name}: max abs err {err}")
        row = {"kernel": "flash_attention", "case": name,
               "shape": list(q.shape), "sk": k.shape[2],
               "bias": None if bias is None else list(bias.shape),
               "max_abs_err": err, "tolerance": K1_TOL[dt]}
        if name.startswith("vit"):
            b, h, sq, dd = q.shape
            nbytes = 4 * q.numel() * q.element_size()
            row.update(bound(nbytes, 4 * b * h * sq * k.shape[2] * dd, dt))
            row.update(k1_times(torch, q, k, v, scale))
            if name == "vit_b1_bfloat16":
                summary["flash_attention"] = row
            elif name == "vit_b8_bfloat16":
                summary["flash_attention_b8"] = row
            elif name == f"vit_strided_b{vit['calib']}_bfloat16":
                summary["flash_attention_calib"] = row
            elif name == f"vit_strided_b{vit['train']}_bfloat16":
                summary["flash_attention_train"] = row
            elif name == f"vit_strided_b{vit['difws']}_bfloat16":
                summary["flash_attention_difws"] = row
            elif name == f"vit_strided_b{vit['folded']}_bfloat16":
                summary["flash_attention_folded"] = row
            elif name == f"vit_strided_b{8 * vit['folded']}_bfloat16":
                summary["flash_attention_folded_b8"] = row
        elif name.startswith("tome") and name.endswith("bfloat16"):
            b, h, sq, dd = q.shape
            streams = b // 2
            if streams in (1, vit["calib"]):
                # q, k, v and the output once, the bias's one row an image
                nbytes = (4 * q.numel() * q.element_size()
                          + b * sq * bias.element_size())
                row.update(bound(nbytes, 4 * b * h * sq * sq * dd, dt))
                row.update(k1_bias_times(torch, q, k, v, bias, scale))
                summary["flash_attention_tome" if streams == 1
                        else "flash_attention_tome_calib"].append(row)
        rows.append(row)
    big = torch.zeros(1, 1, 8, 144, dtype=torch.bfloat16, device="cuda")
    try:
        flash_attention(big, big, big)
    except ValueError:
        pass
    else:
        check(False, "K1 took a bf16 head dim of 144")

    idxs = [torch.tensor(i, dtype=torch.int32, device="cuda")
            for i in range(12)]
    checked = summary["k2_checked"] = set()
    k2_rows = k2_layer_cases(torch, idxs, "deer_3b", checked)
    summary["indexed_matmul"] = layer_summary(k2_rows)
    summary["indexed_matmul_b8"] = layer_summary(k2_rows, m=256)
    # use_hist: a text row a frame, W x 32 rows a stream
    summary["indexed_matmul_hist"] = layer_summary(k2_rows, m=384)
    summary["indexed_matmul_hist_b8"] = layer_summary(k2_rows, m=3072)
    emit({"phase": "kernels", "cases": rows + k2_rows})
    summary.update(phase_kernels_quantized(torch, idxs, checked))
    for kernel in DECODER_KERNEL.values():
        phase_determinism_and_graph(torch, idxs, kernel, checked)
        phase_configs(torch, idxs, kernel, checked)
    return summary


def k2_layer_cases(torch, idxs, model: str, checked: set) -> list:
    """K2 at ``model``'s four products in each of its ``INDEXED_CASES``,
    every layer held against the plain version, then timed."""
    from deer_vla_tpu_torch.ops.kernels.indexed_matmul import (
        indexed_matmul, indexed_matmul_reference)
    rows = []
    for streams, dts in INDEXED_CASES[model]:
        for name, x, w in k2_cases(torch, streams, getattr(torch, dts),
                                   model):
            m, kk = x.shape
            n = w.shape[2]
            rows.append(indexed_case(
                torch, "indexed_matmul", name, x, n,
                (kk * n + m * kk + m * n) * x.element_size(),
                lambda i: indexed_matmul(x, w, i),
                lambda i: indexed_matmul_reference(x, w, i),
                lambda i: x @ w[i], idxs, checked))
    return rows


def phase_kernels_9b(torch, checked: set) -> dict:
    """K2, K3 and K4 at deer_9b's four products (K = 4096 / 16384, N up to
    16384): each ``INDEXED_CASES["deer_9b"]`` case in all 12 layers against
    its plain version, timed against its bound and cuBLAS on ``W[i]``; two
    launches and CUDA-graph replays bit-identical at B=1 and B=8; each
    block config at ``K2_CONFIG_ROWS``; the cases join ``checked``.
    Returns the layer summaries, keys suffixed ``_9b``."""
    idxs = [torch.tensor(i, dtype=torch.int32, device="cuda")
            for i in range(12)]
    k2_rows = k2_layer_cases(torch, idxs, "deer_9b", checked)
    out = {"indexed_matmul_9b": layer_summary(k2_rows),
           "indexed_matmul_9b_b8": layer_summary(k2_rows, m=256)}
    emit({"phase": "kernels_9b", "model": "deer_9b", "cases": k2_rows})
    del k2_rows
    torch.cuda.empty_cache()
    out.update({k.replace("_b8", "_9b_b8") if k.endswith("_b8")
                else k + "_9b": v
                for k, v in phase_kernels_quantized(torch, idxs, checked,
                                                    "deer_9b").items()})
    for kernel in DECODER_KERNEL.values():
        phase_determinism_and_graph(torch, idxs, kernel, checked, "deer_9b",
                                    (1, 8))
        out[kernel + "_9b_configs"] = phase_configs(torch, idxs, kernel,
                                                    checked, "deer_9b")
        torch.cuda.empty_cache()
    # one tp=4 rank's local stacks (tp_serve_9b launches K2-K4 on them)
    tp_rows = k2_layer_cases(torch, idxs, "deer_9b_tp4", checked)
    out["indexed_matmul_9b_tp4"] = layer_summary(tp_rows)
    out["indexed_matmul_9b_tp4_b8"] = layer_summary(tp_rows, m=256)
    emit({"phase": "kernels_9b_tp4", "model": "deer_9b_tp4",
          "cases": tp_rows})
    out.update({k.replace("_b8", "_9b_tp4_b8") if k.endswith("_b8")
                else k + "_9b_tp4": v
                for k, v in phase_kernels_quantized(
                    torch, idxs, checked, "deer_9b_tp4").items()})
    torch.cuda.empty_cache()
    return out


def indexed_kernel(kernel: str):
    """(wrapper, plain version, plan function, block configs) of the
    layer-indexed matmul ``kernel``; the wrappers take the stacked weights
    as ``stacked_weights`` gives them, after x."""
    from deer_vla_tpu_torch.ops.kernels import indexed_matmul as imm
    if kernel == "indexed_matmul":
        return (imm.indexed_matmul, imm.indexed_matmul_reference,
                imm.indexed_matmul_plan, imm.K2_CONFIGS)
    q4 = kernel == "indexed_matmul_q4"
    return (getattr(imm, kernel), getattr(imm, kernel + "_reference"),
            lambda m, k, n, config=None: imm.indexed_matmul_quant_plan(
                m, k, n, q4, config=config),
            imm.QUANT_CONFIGS)


def stacked_weights(torch, gen, kernel: str, k: int, n: int) -> tuple:
    """The 12-layer stack of one decoder product as ``kernel`` takes it:
    (W,) in bf16 for K2, (int8 codes, scales) for K3, (packed int4 codes,
    scales) for K4, quantized from the same kind of random weights."""
    from deer_vla_tpu_torch.ops.quant import quantize_weight, quantize_weight4
    w = torch.randn(12, k, n, generator=gen, device="cuda") * k ** -0.5
    if kernel == "indexed_matmul":
        return (w.to(torch.bfloat16),)
    return (quantize_weight4 if kernel == "indexed_matmul_q4"
            else quantize_weight)(w)


def phase_determinism_and_graph(torch, idxs, kernel: str, checked: set,
                                model: str = "deer_3b",
                                streams_list=(1, 2, 3, 4, 8)) -> None:
    """The split-K sums are combined in a fixed order: two launches give
    bit-identical outputs.  The four products of a layer captured once in a
    CUDA graph, replayed after ``idx.fill_(j)`` for each of the 12 layers,
    equal the eager launches bit for bit and the plain version within
    K2_REL_TOL: the layer index is read on the device at every replay."""
    fn, plain, plan_of, _ = indexed_kernel(kernel)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    stacks = [(prod, stacked_weights(torch, gen, kernel, k, n))
              for prod, k, n in DECODER_PRODUCTS[model]]
    phase = ("k2" if kernel == "indexed_matmul" else "k3_k4") \
        + "_determinism_and_graph" + ("_9b" if model == "deer_9b" else "")
    out = {"phase": phase, "kernel": kernel, "model": model, "cases": []}
    for streams in streams_list:
        prods = [(f"{prod}_b{streams}",
                  torch.randn(32 * streams, w[0].shape[1] * (
                      2 if kernel == "indexed_matmul_q4" else 1),
                      generator=gen, device="cuda").to(torch.bfloat16), w)
                 for prod, w in stacks]
        splits = [plan_of(x.shape[0], x.shape[1], w[0].shape[2]).splits
                  for _, x, w in prods]
        for (name, x, w), sp in zip(prods, splits):
            a = fn(x, *w, idxs[5])
            b = fn(x, *w, idxs[5])
            check(torch.equal(a, b), f"{kernel} {name}: two launches differ "
                                     f"(splits {sp})")
        idx = torch.zeros((), dtype=torch.int32, device="cuda")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up outside the capture
            for _ in range(2):
                [fn(x, *w, idx) for _, x, w in prods]
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            ys = [fn(x, *w, idx) for _, x, w in prods]
        worst = 0.0
        for j in range(12):
            idx.fill_(j)
            graph.replay()
            torch.cuda.synchronize()
            for (name, x, w), y in zip(prods, ys):
                check(torch.equal(y, fn(x, *w, idxs[j])),
                      f"{kernel} {name}: graph replay at layer {j} differs "
                      f"from the eager launch")
                ref = plain(x, *w, idxs[j]).float()
                err = (y.float() - ref).abs().max().item()
                tol = K2_REL_TOL["bfloat16"] * ref.abs().max().item()
                check(err <= tol, f"{kernel} {name}: graph replay at layer "
                                  f"{j}: {err} > {tol}")
                worst = max(worst, err / tol)
                checked.add((kernel, x.shape[0], x.shape[1], y.shape[1],
                             "bfloat16"))
        out["cases"].append({"streams": streams,
                             "products": [p[0] for p in prods],
                             "splits": splits, "repeat_bit_identical": True,
                             "graph_layers_replayed": 12,
                             "graph_equals_eager": True,
                             "graph_worst_err_over_tol": worst})
        del graph, ys, prods
    emit(out)


def phase_configs(torch, idxs, kernel: str, checked: set,
                  model: str = "deer_3b") -> dict:
    """Each block config of ``kernel`` (its plan function's ``config=c``) on
    the decoder's four products at ``K2_CONFIG_ROWS`` rows: checked against
    the plain version at the first and last layer, then timed cycling
    through the layers, so the config the plan picks for a row count is
    seen beside the others.  Returns the layer times by row count."""
    fn, plain, plan_of, configs = indexed_kernel(kernel)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    rows = []
    layer = {m: [0.0] * len(configs) for m in K2_CONFIG_ROWS}
    planned = {}
    for prod, k, n in DECODER_PRODUCTS[model]:
        w = stacked_weights(torch, gen, kernel, k, n)
        xs = torch.randn(max(K2_CONFIG_ROWS), k, generator=gen,
                         device="cuda").to(torch.bfloat16)
        for m in K2_CONFIG_ROWS:
            x = xs[:m]
            planned[m] = plan_of(m, k, n).config
            for c in range(len(configs)):
                plan = plan_of(m, k, n, config=c)
                err = tol = 0.0
                for j in (0, 11):
                    got = fn(x, *w, idxs[j], plan=plan).float()
                    ref = plain(x, *w, idxs[j]).float()
                    err = max(err, (got - ref).abs().max().item())
                    tol = max(tol, K2_REL_TOL["bfloat16"]
                              * ref.abs().max().item())
                check(err <= tol, f"{kernel} {prod} m={m} config {c}: max "
                                  f"abs err {err} > {tol}")
                checked.add((kernel, m, k, n, "bfloat16"))
                it = iter(range(10 ** 9))
                ms = graph_ms(torch, lambda: fn(
                    x, *w, idxs[next(it) % 12], plan=plan), 48)
                layer[m][c] += ms
                rows.append({"product": prod, "m": m, "config": c,
                             "instruction": plan.instruction,
                             "splits": plan.splits, "blocks": plan.blocks,
                             "planned": c == planned[m], "ms": ms,
                             "max_abs_err": err, "tolerance": tol})
        del w, xs
    by_rows = {m: {"planned": planned[m], "by_config": ms,
                   "fastest": min(range(len(ms)), key=ms.__getitem__)}
               for m, ms in layer.items()}
    emit({"phase": ("k2_configs" if kernel == "indexed_matmul"
                    else "k3_k4_configs")
          + ("_9b" if model == "deer_9b" else ""), "kernel": kernel,
          "model": model,
          "configs": [c._asdict() for c in configs],
          "layer_ms": by_rows, "rows": rows})
    return by_rows


def phase_kernels_quantized(torch, idxs, checked: set,
                            model: str = "deer_3b") -> dict:
    """K3 and K4 at ``model``'s four decoder products.  The library call is
    cuBLAS's ``x @ Wd[idx]`` over the same stack dequantized to x's dtype
    beforehand: the product that quantized serving exists to beat."""
    from deer_vla_tpu_torch.ops.kernels.indexed_matmul import (
        indexed_matmul_q4, indexed_matmul_q4_reference, indexed_matmul_q8,
        indexed_matmul_q8_reference)
    from deer_vla_tpu_torch.ops.quant import (dequantize_weight,
                                              dequantize_weight4,
                                              quantize_weight,
                                              quantize_weight4)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 100)
    rows = {"indexed_matmul_q8": [], "indexed_matmul_q4": []}
    for prod, k, n in DECODER_PRODUCTS[model]:
        w = torch.randn(12, k, n, generator=gen, device="cuda") * k ** -0.5
        q8, s8 = quantize_weight(w)
        q4, s4 = quantize_weight4(w)
        del w
        xs = {(streams, dts): torch.randn(32 * streams, k, generator=gen,
                                          device="cuda").to(getattr(torch,
                                                                    dts))
              for streams, dts in INDEXED_CASES[model]}
        for kernel, fn, plain, wq, s, deq, wbytes in (
                ("indexed_matmul_q8", indexed_matmul_q8,
                 indexed_matmul_q8_reference, q8, s8,
                 lambda dt: dequantize_weight(q8, s8, dt), k * n),
                ("indexed_matmul_q4", indexed_matmul_q4,
                 indexed_matmul_q4_reference, q4, s4,
                 lambda dt: dequantize_weight4(q4, s4, dt), k * n // 2)):
            wd = {}
            for (streams, dts), x in xs.items():
                if dts not in wd:
                    wd[dts] = deq(getattr(torch, dts))
                m = x.shape[0]
                es = x.element_size()
                rows[kernel].append(indexed_case(
                    torch, kernel, f"{prod}_b{streams}_{dts}", x, n,
                    wbytes + 4 * n + (m * k + m * n) * es,
                    lambda i: fn(x, wq, s, i),
                    lambda i: plain(x, wq, s, i),
                    lambda i: x @ wd[dts][i], idxs, checked))
            del wd
    emit({"phase": "kernels_quantized"
          + ("" if model == "deer_3b" else model[4:]), "model": model,
          "library": "x @ Wd[idx], Wd dequantized to x.dtype beforehand "
                     "(cuBLAS)",
          "cases": rows["indexed_matmul_q8"] + rows["indexed_matmul_q4"]})
    out = {}
    for kernel, r in rows.items():
        out[kernel] = layer_summary(r)
        out[kernel + "_b8"] = layer_summary(r, m=256)
    return out


def make_policy_inputs(np, cfg, b: int, seed: int):
    r = np.random.RandomState(seed)
    hw = cfg.vit.image_size
    img = r.randn(b, 1, 1, 3, hw, hw).astype(np.float32)
    grip = r.randn(b, 1, 1, 3, hw, hw).astype(np.float32)
    ids = r.randint(0, cfg.media_token_id, size=(b, cfg.text_len))
    ids[:, 0] = cfg.media_token_id
    mask = np.ones((b, cfg.text_len), np.int64)
    mask[:, cfg.text_len - 4:] = 0  # a padded tail
    return img, grip, ids, mask


def build_weights(torch, cfg):
    """Seeded random weights of ``cfg`` on the card.  The init leaves the
    cross-attention gates at zero, as the reference does; they are drawn
    here so that the vision path reaches the actions."""
    from deer_vla_tpu_torch.models.flamingo import init_deer
    params = init_deer(cfg, seed=SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for x in params["decoder"]["xattn"]:
        if x is None:
            continue
        x["attn_gate"].uniform_(-0.5, 0.5, generator=gen)
        x["ff_gate"].uniform_(-0.5, 0.5, generator=gen)
    return params


# the depths of the deer_3b cross-checks against fp32 on the CPU after the
# main one (quantized, variants, heads, the train step): the same draw's
# first decoder layers (cross-attention on each, exits [1, 3]) and ViT
# layers (the CPU's fp32 ViT over a W=12 window held the folded ones)
CROSS_DEPTH = 4
CROSS_VIT_DEPTH = 8


def cut_depth(cfg, n_layers: int, vit_layers: int = None):
    """``cfg`` with its decoder cut to ``n_layers`` (the exits follow) and
    its ViT to ``vit_layers`` when given."""
    cfg = dataclasses.replace(cfg, mpt=dataclasses.replace(
        cfg.mpt, n_layers=n_layers))
    if vit_layers is not None:
        cfg = dataclasses.replace(cfg, vit=dataclasses.replace(
            cfg.vit, layers=vit_layers))
    return cfg


def first_layers(params: dict, cfg) -> dict:
    """The tree of ``params`` cut to ``cfg``'s depths: its first decoder
    layers (blocks, cross-attention) and ViT blocks, and the exit heads of
    the exits left; the same tensors, no copy."""
    n = cfg.n_layers
    dec = dict(params["decoder"], blocks=params["decoder"]["blocks"][:n],
               xattn=params["decoder"]["xattn"][:n])
    vit = dict(params["vit"], blocks=params["vit"]["blocks"][:cfg.vit.layers])
    keep = {str(i) for i in cfg.exit_layer_ids()}
    return dict(params, decoder=dec, vit=vit,
                lm_exits={k: v for k, v in params["lm_exits"].items()
                          if k in keep})


def kernel_counters():
    """Each kernel wrapper by name: the object its ``launches`` count is
    on."""
    from deer_vla_tpu_torch.ops.kernels import flash_attention as fa
    from deer_vla_tpu_torch.ops.kernels.indexed_matmul import (
        indexed_matmul, indexed_matmul_q4, indexed_matmul_q8)
    return {f.__name__: f for f in (
        fa.flash_attention, fa.flash_attention_backward, indexed_matmul,
        indexed_matmul_q8, indexed_matmul_q4)}


# the decoder kernel each serving mode must launch (w8a8 modes: none, their
# decoder products are int8 x int8 -> int32 products outside the kernels)
DECODER_KERNEL = {None: "indexed_matmul", "int8": "indexed_matmul_q8",
                  "int4": "indexed_matmul_q4"}


def phase_serve(torch, np, cfg, pol, quantize=None, b1_steps=8,
                b8_steps=4, name=None, config="deer_3b",
                sweep=SWEEP, inputs=None) -> dict:
    """Serve ``b1_steps`` single-stream steps, then ``b8_steps`` eight-stream
    steps, with every kernel's launch count set to 0 just before and read
    just after; the thresholds are ``sweep``'s, one a step (a stream at
    B=8).  ``inputs(b, seed)`` gives a step's (args, keyword args)
    (``make_policy_inputs`` unless given).  The actions are (7,) or a
    (k, 7) plan a stream.  An MPT decoder must launch its mode's decoder
    kernel; a llama decoder none of K2-K4, and K1 once a ViT layer a
    step."""
    from deer_vla_tpu_torch.ops.quant import tree_bytes
    if inputs is None:
        def inputs(b, seed):
            return make_policy_inputs(np, cfg, b, seed), {}
    k = cfg.head.multi_step_action
    plan = (k, 7) if k > 1 else (7,)
    if cfg.head_type == "diffusion":  # the chosen exit's feature
        plan = (cfg.head.hidden_size,)
    n_exits = len(pol.exits)
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    b1_ms, b1_exits = [], []
    pol.reset()
    for s in range(b1_steps):
        pol.set_thresholds([sweep[s]] * n_exits)
        args, kw = inputs(1, 100 + s)
        t0 = time.perf_counter()
        act = pol.step(*args, **kw)
        b1_ms.append((time.perf_counter() - t0) * 1e3)
        check(act.shape == plan and bool(np.isfinite(act).all()),
              f"{quantize} B=1 step {s}: action {act}")
        b1_exits.append(pol.last_exit_layer)
    b8_ms, b8_exits = [], []
    pol.set_thresholds_batch([[t] * n_exits for t in sweep])
    pol.reset()
    for s in range(b8_steps):
        args, kw = inputs(8, 200 + s)
        t0 = time.perf_counter()
        acts, exits = pol.step_batch(*args, **kw)
        b8_ms.append((time.perf_counter() - t0) * 1e3)
        check(acts.shape == (8,) + plan and bool(np.isfinite(acts).all()),
              f"{quantize} B=8 step {s}: non-finite actions")
        b8_exits.append(exits.tolist())
    launches = {name: f.launches for name, f in counters.items()}
    every = set(b1_exits) | {e for row in b8_exits for e in row}
    check(every <= set(pol.exits), f"exit layers {every} not in {pol.exits}")
    if b1_steps:
        check(len(set(b1_exits)) > 1, f"{quantize} B=1 exits all at "
                                      f"{b1_exits}")
    steps = b1_steps + b8_steps
    if cfg.mpt.arch == "llama":
        check(launches["flash_attention"] == cfg.vit.layers * steps
              and all(launches[k] == 0 for k in DECODER_KERNEL.values()),
              f"{config} {quantize}: K1 must run {cfg.vit.layers} times a "
              f"step and K2-K4 not: {launches}")
    else:
        decoder = DECODER_KERNEL.get(quantize)
        check(launches["flash_attention"] > 0
              and (decoder is None or launches[decoder] > 0),
              f"{quantize}: kernels not launched on the main path: "
              f"{launches}")
        if quantize:
            check(launches["indexed_matmul"] == 0,
                  f"{quantize}: the bf16 kernel K2 ran: {launches}")
    out = {"phase": name or ("serve" if quantize is None
                             else f"serve_{quantize}"),
           "config": config, "quantize": quantize,
           "tome_r": cfg.vit.tome_r,
           "vit": [cfg.vit.layers, cfg.vit.width], "mpt": [cfg.n_layers,
                                                           cfg.mpt.d_model],
           "compute": str(cfg.dtypes.cdt)[6:],
           "params": str(cfg.dtypes.pdt)[6:],
           "b1_thresholds": sweep[:b1_steps], "b1_exit_layers": b1_exits,
           "b1_step_ms": b1_ms,
           "b1_median_ms": statistics.median(b1_ms) if b1_ms else None,
           "b8_stream_thresholds": sweep, "b8_exit_layers": b8_exits,
           "b8_step_ms": b8_ms, "b8_median_ms": statistics.median(b8_ms),
           "launches": launches,
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "stacked_bytes": tree_bytes(pol.stacked),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    return out


SERVE_MODES = (("int8", 8), ("int4", 8), ("int8_w8a8", 0), ("int4_w8a8", 0))


def phase_serve_quantized(torch, np, cfg, params, bf16_bytes: int,
                          modes=SERVE_MODES, config="deer_3b",
                          sweep=SWEEP, prefix="serve") -> dict:
    """Each (mode, B=1 steps) of ``modes`` at B=1 and B=8: int8 and int4
    through K3 / K4 on an MPT decoder, the w8a8 modes at B=8 only; each
    policy is freed before the next is built."""
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    out = {}
    for mode, b1_steps in modes:
        pol = ScanDeerPolicy(params, cfg, indexed_mm=cfg.mpt.arch == "mpt",
                             quantize=mode)
        torch.cuda.reset_peak_memory_stats()
        res = phase_serve(torch, np, cfg, pol, mode, b1_steps=b1_steps,
                          name=f"{prefix}_{mode}", config=config,
                          sweep=sweep)
        res["stacked_bytes_vs_bf16"] = res["stacked_bytes"] / bf16_bytes
        out[mode] = res
        del pol
        torch.cuda.empty_cache()
    emit({"phase": f"{prefix}_quantized_summary", "config": config,
          "stacked_bytes_bf16": bf16_bytes,
          "modes": {m: {"b1_median_ms": r["b1_median_ms"],
                        "b8_median_ms": r["b8_median_ms"],
                        "stacked_bytes": r["stacked_bytes"],
                        "stacked_bytes_vs_bf16": r["stacked_bytes_vs_bf16"],
                        "launches": r["launches"]}
                    for m, r in out.items()}})
    return out


def full_depth_step(np, pol, cfg, inputs, kw=None):
    pol.set_thresholds([-1.0] * (len(pol.exits) - 1) + [1e8])
    pol.reset()
    act = pol.step(*inputs, **(kw or {}))
    check(pol.last_exit_layer == cfg.n_layers - 1,
          f"full-depth step exited at {pol.last_exit_layer}")
    return act[:6], pol.last_hidden.float().cpu()


def compare(np, torch, act, hid, act_ref, hid_ref) -> dict:
    return {"arm_max_abs": float(np.abs(act - act_ref).max()),
            "hidden_rel_l2": float(torch.linalg.vector_norm(hid - hid_ref)
                                   / torch.linalg.vector_norm(hid_ref))}


def phase_cross_check(torch, np, cfg, params, cpu_params, pol,
                      name="cross_check", inputs=None) -> dict:
    """One full-depth step of ``pol`` (bf16, the kernels) and of the same
    weights in fp32 on the card, each against fp32 on the CPU through the
    plain versions (``CROSS_TOL_BF16`` / ``CROSS_TOL_FP32``); ``inputs``
    (args, keyword args) of the step, ``make_policy_inputs``' unless
    given."""
    from deer_vla_tpu_torch.core.config import FP32
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    inputs, kw = inputs or (make_policy_inputs(np, cfg, 1, seed=300), {})
    act_bf16, hid_bf16 = full_depth_step(np, pol, cfg, inputs, kw)
    cfg32 = dataclasses.replace(cfg, dtypes=FP32)
    card32 = ScanDeerPolicy(params, cfg32, indexed_mm=True)
    act_f32, hid_f32 = full_depth_step(np, card32, cfg32, inputs, kw)
    del card32
    t0 = time.perf_counter()
    cpu = ScanDeerPolicy(cpu_params, cfg32, indexed_mm=True, device="cpu")
    act_ref, hid_ref = full_depth_step(np, cpu, cfg32, inputs, kw)
    cpu_s = time.perf_counter() - t0
    bf16 = compare(np, torch, act_bf16, hid_bf16, act_ref, hid_ref)
    f32 = compare(np, torch, act_f32, hid_f32, act_ref, hid_ref)
    del cpu
    out = {"phase": name, "exit_layer": cfg.n_layers - 1,
           "card_bf16_vs_cpu_fp32": bf16, "tol_bf16": CROSS_TOL_BF16,
           "card_fp32_vs_cpu_fp32": f32, "tol_fp32": CROSS_TOL_FP32,
           "arm_card_bf16": act_bf16.tolist(),
           "arm_cpu_fp32": act_ref.tolist(), "cpu_seconds": cpu_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    for got, tol, what in ((bf16, CROSS_TOL_BF16, "bf16"),
                           (f32, CROSS_TOL_FP32, "fp32")):
        for key, limit in tol.items():
            check(got[key] <= limit, f"{name} {what} {key} {got[key]}")
    return out


def phase_cross_check_quantized(torch, np, cfg, params, cpu_params) -> None:
    """int8 and int4: the same fp32 weights quantized on the card and on the
    CPU must give the same codes and scales bit for bit; then one
    full-depth fp32 step on each (K3 / K4's fp32 paths on the card, their
    plain versions on the CPU) must agree within CROSS_TOL_FP32."""
    from deer_vla_tpu_torch.core.config import FP32
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    inputs = make_policy_inputs(np, cfg, 1, seed=300)
    cfg32 = dataclasses.replace(cfg, dtypes=FP32)
    for mode, keys in (("int8", ("q", "s")), ("int4", ("q4", "s4"))):
        card = ScanDeerPolicy(params, cfg32, indexed_mm=True, quantize=mode)
        act_card, hid_card = full_depth_step(np, card, cfg32, inputs)
        t0 = time.perf_counter()
        cpu = ScanDeerPolicy(cpu_params, cfg32, indexed_mm=True,
                             quantize=mode, device="cpu")
        cpu_bufs = dict(cpu.named_buffers())
        codes = [(name, buf) for name, buf in card.named_buffers()
                 if name.rsplit("__", 1)[-1] in keys]
        differ = [name for name, buf in codes
                  if not torch.equal(buf.cpu(), cpu_bufs[name])]
        check(len(codes) > 0 and not differ,
              f"{mode}: card and CPU quantization differ in {differ[:5]}")
        act_ref, hid_ref = full_depth_step(np, cpu, cfg32, inputs)
        cpu_s = time.perf_counter() - t0
        got = compare(np, torch, act_card, hid_card, act_ref, hid_ref)
        emit({"phase": f"cross_check_{mode}", "exit_layer": cfg.n_layers - 1,
              "quantized_leaves_bit_equal": len(codes),
              "quantized_bytes": sum(b.numel() * b.element_size()
                                     for _, b in codes),
              "card_fp32_vs_cpu_fp32": got, "tol_fp32": CROSS_TOL_FP32,
              "cpu_seconds": cpu_s})
        for key, limit in CROSS_TOL_FP32.items():
            check(got[key] <= limit, f"cross_check {mode} {key} {got[key]}")
        del card, cpu
        torch.cuda.empty_cache()


def calib_debug_batches(cfg, batch_size: int, num_batches: int):
    """DebugBatcher batches at the ViT's resolution and the config with the
    debug tokenizer's media token, as the eval CLI builds them."""
    from deer_vla_tpu_torch.data.debug_data import DebugBatcher
    from deer_vla_tpu_torch.data.text import HashTokenizer
    tok = HashTokenizer(vocab_size=cfg.mpt.vocab_size, max_length=cfg.text_len)
    cfg = dataclasses.replace(cfg, media_token_id=tok.media_token_id)
    hw = cfg.vit.image_size
    return cfg, list(DebugBatcher(cfg, tok, batch_size=batch_size,
                                  num_batches=num_batches, img_hw=hw,
                                  grip_hw=hw, seed=SEED))


def phase_calibrate(torch, np, cfg, params, name="calibrate",
                    model="deer_3b") -> dict:
    """Calibration of ``cfg`` (W=12) on 2 DebugBatcher batches of 2
    trajectories, folded and streamed: each batch is one training forward
    (48 ViT images through K1, every decoder layer kept) and the exit
    deltas, with every kernel's count set to 0 before the batch and read
    after it; ``model`` names its target exit schedule (cli/eval's
    ``--model``)."""
    from deer_vla_tpu_torch.eval.calibrate import (
        generate_calibration_values, streamed_sample_probs)
    from deer_vla_tpu_torch.cli.eval import CALIB_BATCH_SIZE as bs
    from deer_vla_tpu_torch.models.value_net import solve_thresholds
    cfg, batches = calib_debug_batches(cfg, bs, 2)
    exits = list(cfg.all_exit_ids())
    counters = kernel_counters()
    out = {"phase": name, "config": model,
           "window": cfg.window_size, "batch_size": bs,
           "compute": str(cfg.dtypes.cdt)[6:], "regimes": {}}
    for regime in ("folded", "streamed"):
        streamed = regime == "streamed"
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        esp = (streamed_sample_probs(cfg, 1.0, None, "exp", model)
               if streamed else None)
        vals, secs, launches = [], [], []
        for batch in batches:
            for f in counters.values():
                f.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vals.append(generate_calibration_values(  # ends on the host
                params, cfg, [batch], gen=gen, streamed=streamed,
                exit_sample_probs=esp))
            secs.append(time.perf_counter() - t0)
            launches.append({n: f.launches for n, f in counters.items()})
        v = np.concatenate(vals, axis=1)
        per_traj = cfg.window_size // 2 + (1 if streamed else 0)
        check(v.shape == (len(exits), bs * len(batches) * per_traj)
              and bool(np.isfinite(v).all()),
              f"calibrate {regime}: values {v.shape}")
        check(all(n["flash_attention"] > 0 for n in launches),
              f"calibrate {regime}: K1 not launched: {launches}")
        th = {str(r): solve_thresholds(v, r, exits, cfg.n_layers - 1,
                                       model_name=model)[0]
              for r in (1.0, 0.5)}
        out["regimes"][regime] = {
            "values_shape": list(v.shape),
            "min": float(v.min()), "median": float(np.median(v)),
            "max": float(v.max()), "thresholds": th,
            "seconds_per_batch": secs, "launches_per_batch": launches}
    emit(out)
    return out


# The calibration forward on the card in fp32 against fp32 on the CPU: only
# the summation order differs.  The actions (|a| <= 0.06 with these random
# weights) are held to 1e-6, about 270 fp32 ulps; a delta (about 3e-5) is
# the difference of two actions some 2e3 times larger, so its error is
# theirs: 1e-7 absolute (27 ulps of the actions), 1e-2 relative L2.  The
# first run on an H100 measured 1.0e-6 / 1.6e-6 (hidden), 7.5e-9 (actions),
# 1.0e-4 / 4.8e-9 (deltas).
CALIB_TOL_FP32 = {"hidden_rel_l2": 1e-4, "hidden_max_abs_rel": 1e-4,
                  "actions_max_abs": 1e-6, "delta_rel_l2": 1e-2,
                  "delta_max_abs": 1e-7}


def calib_forward(torch, params, cfg, batch, device, gen=None, lay1=None,
                  commits=None):
    """One batch's training forward and both regimes' deltas on ``device``;
    the layer draws come from ``gen`` or ``lay1`` / ``commits``."""
    from deer_vla_tpu_torch.eval.calibrate import batch_inputs
    from deer_vla_tpu_torch.models.flamingo import forward_train
    from deer_vla_tpu_torch.models.value_net import (
        generate_exit_deltas, generate_streamed_exit_deltas)
    exits = list(cfg.all_exit_ids())
    with torch.inference_mode():
        img, gri, ids, mask = batch_inputs(batch, cfg, device)
        out = forward_train(params, img, ids, mask, cfg, gen,
                            vision_gripper=gri, only_extra_exit=True,
                            train=False, rand_layer_ids=lay1)
        folded = generate_exit_deltas(params["extra_exit"], out.hidden_states,
                                      out.rand_layer_feat, cfg, exits)
        streamed = generate_streamed_exit_deltas(
            params["extra_exit"], out.hidden_states, cfg, exits,
            commit_exits=commits)
    return {"hidden": out.hidden_states.float().cpu(),
            "actions": out.final_output.actions.float().cpu(),
            "folded": folded.float().cpu(), "streamed": streamed.float().cpu(),
            "lay1": out.rand_layer_ids}


def phase_calibrate_cross_check(torch, np, cfg, params, cpu_params) -> None:
    """deer_3b at W=2, one trajectory (4 ViT images): the calibration
    forward and both regimes' deltas in fp32 on the card against fp32 on
    the CPU, with the card's layer draws and one commit sequence."""
    from deer_vla_tpu_torch.core.config import FP32, deer_3b
    cfg2, batches = calib_debug_batches(
        deer_3b(window_size=CALIB_CROSS_WINDOW, dtypes=FP32), 1, 1)
    commits = [i % len(cfg2.all_exit_ids()) for i in range(4)]
    card = calib_forward(torch, params, cfg2, batches[0],
                         torch.device("cuda"),
                         gen=torch.Generator(device="cuda").manual_seed(SEED),
                         commits=commits)
    t0 = time.perf_counter()
    cpu = calib_forward(torch, cpu_params, cfg2, batches[0],
                        torch.device("cpu"), lay1=card["lay1"].cpu(),
                        commits=commits)
    cpu_s = time.perf_counter() - t0

    def rel_l2(a, b):
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))

    got = {"hidden_rel_l2": rel_l2(card["hidden"], cpu["hidden"]),
           "hidden_max_abs_rel": float((card["hidden"] - cpu["hidden"]).abs()
                                       .max() / cpu["hidden"].abs().max()),
           "actions_max_abs": float((card["actions"] - cpu["actions"]).abs()
                                    .max())}
    for regime in ("folded", "streamed"):
        got[f"{regime}_delta_rel_l2"] = rel_l2(card[regime], cpu[regime])
        got[f"{regime}_delta_max_abs"] = float(
            (card[regime] - cpu[regime]).abs().max())
    emit({"phase": "calibrate_cross_check", "config": "deer_3b W=2 B=1 fp32",
          "card_fp32_vs_cpu_fp32": got, "tol_fp32": CALIB_TOL_FP32,
          "delta_max": {r: float(cpu[r].abs().max())
                        for r in ("folded", "streamed")},
          "actions_max": float(cpu["actions"].abs().max()),
          "cpu_seconds": cpu_s})
    for key, value in got.items():
        limit = CALIB_TOL_FP32[key.replace("folded_", "")
                               .replace("streamed_", "")]
        check(value <= limit, f"calibrate cross-check {key} {value} > "
                              f"{limit}")


ROLLOUT_ARGV = ["--debug", "--model", "deer_3b", "--calib_batches", "2",
                "--num_sequences_override", "2", "--ep_len", "40",
                "--exit_ratio", "0.5"]


def decoder_kernel(args):
    """The decoder kernel a cli/eval run launches: none on the host-bucketed
    engine (DeerPolicy runs ``linear`` on per-layer weights, as the JAX
    package's segment programs do) or for a llama decoder (K2-K4 compute the
    MPT block's products), else K2 or, quantized, K3 / K4."""
    from deer_vla_tpu_torch.cli import eval as cli
    if cli.model_config(args).mpt.arch != "mpt":
        return None
    bucketed = (args.engine == "bucketed" or args.exit_id is not None
                or args.use_action_ensemble or args.multi_execution > 1
                or args.layerwise_exit_eval)
    if bucketed and args.lanes <= 1:
        return None
    return DECODER_KERNEL[None if args.quantize == "none" else args.quantize]


# the phase_rollout running now ("name"), for dispatch_timings
ROLLOUT_PHASE = {}


def phase_rollout(torch, np, phase: str, argv: list) -> dict:
    """``cli/eval.main(argv)`` in-process on the card, bf16: calibrate
    deer_3b on 2 debug batches (unless --exit_id), serve in DebugEnv
    rollouts of 2 sequences through the engine and options the flags ask
    for; the kernel counts are set to 0 before the call and read after it.
    K1 must launch, the decoder's kernel (``decoder_kernel``) too, and the
    other decoder kernels not."""
    import io
    from deer_vla_tpu_torch.cli import eval as cli
    args = cli.build_parser().parse_args(argv)
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    ROLLOUT_PHASE["name"] = phase
    try:
        with contextlib.redirect_stdout(buf):
            report = cli.main(argv)
    finally:
        ROLLOUT_PHASE.pop("name")
    seconds = time.perf_counter() - t0
    launches = {n: f.launches for n, f in counters.items()}
    text = buf.getvalue()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / f"cli_eval_{phase}.log").write_text(text)
    last = text.strip().splitlines()[-3:]
    th = [float(t) for t in last[0].split(",") if t]
    exits = set(cli.model_config(args).all_exit_ids())
    taken = {e for e, p in enumerate(report["exit_hist"]) if p > 0}
    check(len(th) == (0 if args.exit_id is not None else len(exits))
          and abs(float(last[1]) - report["avg_seq_len"]) < 1e-5
          and abs(float(last[2]) - (report["avg_exit_layer"] - 1)) < 1e-5,
          f"{phase}: parse contract {last}")
    want = exits if args.exit_id is None else {args.exit_id}
    check(taken and taken <= want, f"{phase}: exits {taken} not in {want}")
    decoder = decoder_kernel(args)
    check(launches["flash_attention"] > 0
          and (decoder is None or launches[decoder] > 0),
          f"{phase}: K1 / {decoder} not launched: {launches}")
    others = set(DECODER_KERNEL.values()) - {decoder}
    check(all(launches[k] == 0 for k in others),
          f"{phase}: a decoder kernel other than {decoder} ran: {launches}")
    out = {"phase": phase, "argv": argv, "seconds": seconds,
           "decoder_kernel": decoder,
           "avg_seq_len": report["avg_seq_len"],
           "avg_exit_layer": report["avg_exit_layer"],
           "exit_hist": report["exit_hist"],
           "avg_llm_gflops": report["avg_llm_gflops"],
           "exit_contract_max_abs_gap":
               report.get("exit_contract", {}).get("max_abs_gap"),
           "thresholds": th, "env_steps": report["env_steps"],
           "rollout_seconds": report["rollout_seconds"],
           "steps_per_s": report["env_steps"] / report["rollout_seconds"],
           "launches": launches,
           "report": {k: report[k] for k in PIPELINE_SAME}}
    for key in ("action_cache_hit_rate", "vision_cache_hit_rate",
                "batched_exit_waste"):
        if key in report:
            out[key] = report[key]
    emit(out)
    torch.cuda.empty_cache()
    return out


def serve_launches(counters, before: dict) -> dict:
    return {n: f.launches - before.get(n, 0) for n, f in counters.items()}


def phase_serve_bucketed(torch, np, cfg, deer, scan_plain, serve,
                         name="serve_bucketed", config="deer_3b",
                         sweep=SWEEP, inputs=None) -> dict:
    """The host-bucketed ``DeerPolicy`` (bf16, a controller with ``sweep``'s
    threshold a step): 8 single-stream steps with the kernel counts set to
    0 before and read after (K1 in the encode prefix; K2-K4 must not run:
    the decoder runs ``linear`` on per-layer weights).  Each step is then
    held against ``scan_plain``, a ``ScanDeerPolicy`` with the same
    products (cuBLAS, indexed_mm off), on the same weights, inputs,
    thresholds and carry: the same exit (BUCKETED_TOL on the actions).
    ``serve`` is phase serve's result, for its B=1 median (K2) beside;
    ``inputs`` as in ``phase_serve``."""
    if inputs is None:
        def inputs(b, seed):
            return make_policy_inputs(np, cfg, b, seed), {}
    k = cfg.head.multi_step_action
    ctrl = deer.controller
    n = len(deer.bucket_exits)
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    steps = []
    deer.reset()
    for s in range(8):
        ctrl.set_threshold_values([sweep[s]] * n)
        step_in = inputs(1, 100 + s)
        carry_in = (None if deer.carry is None
                    else tuple(c.clone() for c in deer.carry))
        deer.set_timestep(s)
        t0 = time.perf_counter()
        act = deer.step(*step_in[0], **step_in[1])
        steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                      "exit": deer.last_exit_layer, "act": act,
                      "inputs": step_in, "carry_in": carry_in})
        check(act.shape == ((k, 7) if k > 1 else (7,))
              and bool(np.isfinite(act).all()),
              f"{name} step {s}: action {act}")
    launches = {n_: f.launches for n_, f in counters.items()}
    check(launches["flash_attention"] > 0
          and all(launches[k] == 0 for k in DECODER_KERNEL.values()),
          f"{name}: K1 must run and K2-K4 not: {launches}")
    exits = [st["exit"] for st in steps]
    check(len(set(exits)) > 1, f"{name}: exits all at {exits}")
    scan_ms, scan_exits, err = [], [], 0.0
    for s, st in enumerate(steps):
        scan_plain.set_thresholds([sweep[s]] * n)
        scan_plain.reset()
        if st["carry_in"] is not None:
            scan_plain.carry, scan_plain._carry_rows = st["carry_in"], 1
        t0 = time.perf_counter()
        act = scan_plain.step(*st["inputs"][0], **st["inputs"][1])
        scan_ms.append((time.perf_counter() - t0) * 1e3)
        scan_exits.append(scan_plain.last_exit_layer)
        err = max(err, float(np.abs(act - st["act"]).max()))
    check(scan_exits == exits,
          f"{name}: exits {exits}, ScanDeerPolicy {scan_exits}")
    check(err <= BUCKETED_TOL["arm_max_abs"],
          f"{name}: actions differ by {err}")
    out = {"phase": name, "config": config,
           "engine": "DeerPolicy", "thresholds": sweep, "exit_layers": exits,
           "b1_step_ms": [st["ms"] for st in steps],
           "b1_median_ms": statistics.median(st["ms"] for st in steps),
           "scan_cublas_exit_layers": scan_exits,
           "scan_cublas_step_ms": scan_ms,
           "scan_cublas_median_ms": statistics.median(scan_ms),
           "scan_k2_b1_median_ms": serve["b1_median_ms"],
           "vs_scan_arm_max_abs": err, "tolerance": BUCKETED_TOL,
           "launches": launches}
    emit(out)
    return out


@contextlib.contextmanager
def merge_log(log: list):
    """While open, appends (src, dst) on the host for every ToMe merge the
    models run (``ops.tome.match_pairs``, one call a merging layer)."""
    from deer_vla_tpu_torch.ops import tome
    match = tome.match_pairs

    def logged(metric, r):
        src, unm, dst = match(metric, r)
        log.append((src.cpu(), dst.cpu()))
        return src, unm, dst

    tome.match_pairs = logged
    try:
        yield log
    finally:
        tome.match_pairs = match


def merges_agree(torch, a: list, b: list) -> list:
    """Per merging layer, the share of (image, merge) entries whose source
    and destination tokens are the same in two runs' logs."""
    check(len(a) == len(b), f"{len(a)} against {len(b)} merging layers")
    return [float(((sa == sb) & (da == db)).float().mean())
            for (sa, da), (sb, db) in zip(a, b)]


def phase_serve_tome(torch, np, cfg, params, cpu_params) -> dict:
    """``ScanDeerPolicy`` with ToMe (r = TOME_R) in bf16: phase_serve's B=1
    and B=8 steps (K1 at the ToMe shapes with their bias), then one
    full-depth step on the card in bf16 and in fp32 against fp32 on the CPU
    through the plain versions, with the merge indices compared layer by
    layer (TOME_TOL_BF16 / CROSS_TOL_FP32 on the step; in fp32 the merges
    must agree)."""
    from deer_vla_tpu_torch.core.config import FP32
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    cfg_t = dataclasses.replace(cfg, vit=dataclasses.replace(
        cfg.vit, tome_r=TOME_R))
    pol = ScanDeerPolicy(params, cfg_t, indexed_mm=True)
    res = phase_serve(torch, np, cfg_t, pol, name="serve_tome")
    inputs = make_policy_inputs(np, cfg, 1, seed=300)
    logs = {"bf16": [], "fp32": [], "cpu": []}
    with merge_log(logs["bf16"]):
        act_bf16, hid_bf16 = full_depth_step(np, pol, cfg_t, inputs)
    del pol
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg_t, dtypes=FP32)
    card32 = ScanDeerPolicy(params, cfg32, indexed_mm=True)
    with merge_log(logs["fp32"]):
        act_f32, hid_f32 = full_depth_step(np, card32, cfg32, inputs)
    del card32
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu = ScanDeerPolicy(cpu_params, cfg32, indexed_mm=True, device="cpu")
    with merge_log(logs["cpu"]):
        act_ref, hid_ref = full_depth_step(np, cpu, cfg32, inputs)
    cpu_s = time.perf_counter() - t0
    del cpu
    bf16 = compare(np, torch, act_bf16, hid_bf16, act_ref, hid_ref)
    f32 = compare(np, torch, act_f32, hid_f32, act_ref, hid_ref)
    agree_bf16 = merges_agree(torch, logs["bf16"], logs["cpu"])
    agree_f32 = merges_agree(torch, logs["fp32"], logs["cpu"])
    out = {"phase": "serve_tome_cross_check", "tome_r": TOME_R,
           "merging_layers": len(logs["cpu"]),
           "bf16_first_layer_merging_otherwise": next(
               (i for i, a in enumerate(agree_bf16) if a < 1.0), None),
           "card_bf16_vs_cpu_fp32": bf16, "tol_bf16": TOME_TOL_BF16,
           "card_fp32_vs_cpu_fp32": f32, "tol_fp32": CROSS_TOL_FP32,
           "merges_agree_bf16_per_layer": agree_bf16,
           "merges_agree_fp32_per_layer": agree_f32, "cpu_seconds": cpu_s}
    emit(out)
    for got, tol, what in ((bf16, TOME_TOL_BF16, "bf16"),
                           (f32, CROSS_TOL_FP32, "fp32")):
        for key, limit in tol.items():
            check(got[key] <= limit, f"serve_tome {what} {key} {got[key]}")
    check(all(a == 1.0 for a in agree_f32),
          f"serve_tome: fp32 merges differ from the CPU's: {agree_f32}")
    res["cross_check"] = out
    return res


# frames of the cache phases: a frame three times, a new one twice
CACHE_FRAMES = (0, 0, 0, 1, 1)
# the action cache: the first frame four times (a refresh at the fourth),
# then a new one twice: misses at 0, 3, 4, hits at 1, 2, 5
ACTION_CACHE_FRAMES = (0, 0, 0, 0, 1, 1)


def phase_caches(torch, np, cfg, scan, deer) -> dict:
    """The vision caches around ``scan`` (ScanDeerPolicy, K2) and ``deer``
    (DeerPolicy) over CACHE_FRAMES: encode hits counted (K1 launches only on
    a miss), and every step's action equal to the uncached policy's step
    from the same carry; then the action cache around ``scan`` over
    ACTION_CACHE_FRAMES: hits, refreshes and the replayed actions."""
    from deer_vla_tpu_torch.eval.caching import (ActionCachePolicy,
                                                 VisionCacheDeerPolicy,
                                                 VisionCacheScanPolicy)
    counters = kernel_counters()
    n = len(scan.exits)
    scan.set_thresholds([SWEEP[3]] * n)
    deer.controller.set_threshold_values([SWEEP[3]] * n)
    out = {"phase": "caches", "thresholds": [SWEEP[3]] * n, "vision": {}}
    for name, inner, wrap in (("scan", scan, VisionCacheScanPolicy),
                              ("bucketed", deer, VisionCacheDeerPolicy)):
        cache = wrap(inner, tau=0.05)
        launches = {k: 0 for k in counters}
        exits, ms = [], []
        for t, seed in enumerate(CACHE_FRAMES):
            inputs = make_policy_inputs(np, cfg, 1, seed=500 + seed)
            carry_in = (None if inner.carry is None
                        else tuple(c.clone() for c in inner.carry))
            before = {k: f.launches for k, f in counters.items()}
            cache.set_timestep(t)
            t0 = time.perf_counter()
            act = cache.step(*inputs)
            ms.append((time.perf_counter() - t0) * 1e3)
            for k, v in serve_launches(counters, before).items():
                launches[k] += v
            exit_layer, carry_out = cache.last_exit_layer, inner.carry
            inner.carry = carry_in
            if name == "scan" and carry_in is not None:
                inner._carry_rows = 1
            ref = inner.step(*inputs)
            check(np.array_equal(act, ref)
                  and inner.last_exit_layer == exit_layer,
                  f"caches {name} step {t}: {act} / {exit_layer} against "
                  f"the uncached {ref} / {inner.last_exit_layer}")
            inner.carry = carry_out
            exits.append(exit_layer)
        misses = len(set(CACHE_FRAMES))
        check(cache.encode_hits == len(CACHE_FRAMES) - misses,
              f"caches {name}: {cache.encode_hits} encode hits")
        check(launches["flash_attention"] == misses * VIT_LAYERS,
              f"caches {name}: K1 ran {launches['flash_attention']} times "
              f"for {misses} encodes")
        out["vision"][name] = {"encode_hits": cache.encode_hits,
                               "steps": cache.steps, "exit_layers": exits,
                               "step_ms": ms, "launches": launches}
    scan.reset()
    cache = ActionCachePolicy(scan, tau=0.03, refresh_every=3)
    acts, exits = [], []
    for t, seed in enumerate(ACTION_CACHE_FRAMES):
        cache.set_timestep(t)
        acts.append(cache.step(*make_policy_inputs(np, cfg, 1,
                                                   seed=500 + seed)))
        exits.append(cache.last_exit_layer)
    hits = [e == -1 for e in exits]
    frames = ACTION_CACHE_FRAMES
    refreshes = sum(not h and t > 0 and frames[t] == frames[t - 1]
                    for t, h in enumerate(hits))
    check(hits == [False, True, True, False, False, True] and refreshes == 1
          and cache.hits == 3 and cache.steps == 6
          and np.array_equal(acts[1], acts[0])
          and np.array_equal(acts[5], acts[4]),
          f"action cache: exits {exits}, {cache.hits} hits")
    out["action"] = {"hits": cache.hits, "steps": cache.steps,
                     "refreshes": refreshes, "exit_layers": exits}
    out["launches"] = {k: sum(v["launches"][k] for v in out["vision"].values())
                       for k in counters}
    emit(out)
    return out


def phase_batched_bucketed(torch, np, cfg, params, scan_plain) -> dict:
    """``BatchedDeerPolicy`` at B=8 (one shared threshold, SWEEP[3], at
    every exit), 4 steps, against ``scan_plain.step_batch`` on the same
    inputs from the same (zero) carry: the same exits per stream, actions
    within BUCKETED_TOL; the kernel counts are those of the batched steps
    (K1 in its encode, no K2-K4)."""
    from deer_vla_tpu_torch.eval.batched_policy import BatchedDeerPolicy
    n = len(scan_plain.exits)
    bp = BatchedDeerPolicy(params, cfg, batch=8,
                           thresholds=[SWEEP[3]] * (n - 1) + [1e8])
    scan_plain.set_thresholds([SWEEP[3]] * n)
    scan_plain.reset()
    counters = kernel_counters()
    launches = {k: 0 for k in counters}
    ms, exits, err = [], [], 0.0
    for s in range(4):
        inputs = make_policy_inputs(np, cfg, 8, seed=200 + s)
        before = {k: f.launches for k, f in counters.items()}
        t0 = time.perf_counter()
        acts, ex = bp.step(*inputs)
        ms.append((time.perf_counter() - t0) * 1e3)
        for k, v in serve_launches(counters, before).items():
            launches[k] += v
        ref, ex_ref = scan_plain.step_batch(*inputs)
        check(np.array_equal(ex, ex_ref),
              f"batched_bucketed step {s}: exits {ex} against {ex_ref}")
        err = max(err, float(np.abs(acts - ref).max()))
        exits.append(ex.tolist())
    check(err <= BUCKETED_TOL["arm_max_abs"],
          f"batched_bucketed: actions differ by {err}")
    check(launches["flash_attention"] > 0
          and all(launches[k] == 0 for k in DECODER_KERNEL.values()),
          f"batched_bucketed: K1 must run and K2-K4 not: {launches}")
    out = {"phase": "batched_bucketed", "batch": 8, "threshold": SWEEP[3],
           "exit_layers": exits, "b8_step_ms": ms,
           "b8_median_ms": statistics.median(ms),
           "vs_scan_arm_max_abs": err, "tolerance": BUCKETED_TOL,
           "launches": launches}
    emit(out)
    return out


def train_inputs(torch, cfg, device):
    """One DebugBatcher batch (1 trajectory of cfg's window) as the train
    step takes it on ``device``, no random shift, and fixed layer draws
    (sampling 1 the exits in turn, sampling 2 the last exit)."""
    from deer_vla_tpu_torch.train.trainer import TrainConfig, prepare_batch
    cfg, batches = calib_debug_batches(cfg, 1, 1)
    batch = prepare_batch(batches[0], cfg, None,
                          TrainConfig(rgb_pad=0, gripper_pad=0), device)
    exits = cfg.all_exit_ids()
    w = cfg.window_size
    draws = {"rand_layer_ids": torch.tensor([[exits[i % len(exits)]
                                              for i in range(w)]]),
             "switch_layer_ids": torch.full((1, w), exits[-1])}
    return cfg, batch, draws


def train_step_parts(torch, params, cfg, batch, draws, snapshot: bool):
    """One joint-phase step of ``make_train_step``, its gradients read where
    the step hands them to the update: (loss, {key: grad}, {key: param
    after the update}, and with ``snapshot`` {key: param before it}), all
    on the CPU in fp32."""
    from deer_vla_tpu_torch.models.flamingo import trainable_mask
    from deer_vla_tpu_torch.train.optimizer import (flat_leaves,
                                                    make_optimizer)
    from deer_vla_tpu_torch.train.train_step import (init_train_state,
                                                     make_train_step)
    opt = make_optimizer(params, cfg, phase="joint", learning_rate=1e-4,
                         warmup_steps=0, total_steps=1,
                         trainable=trainable_mask(params, cfg, "joint"))
    keys = opt.trainable_keys()
    flat = flat_leaves(params)
    before = ({k: flat[k].detach().float().cpu().clone() for k in keys}
              if snapshot else None)
    grads = {}

    def keep(step_grads, loss, metrics):
        grads.update({k: g.float().cpu() for k, g in step_grads.items()})

    with on_update(keep):
        _, metrics = make_train_step(cfg, opt)(
            init_train_state(params, opt), batch, draws=[draws])
    return (float(metrics["loss"]), grads,
            {k: flat[k].float().cpu() for k in keys}, before)


def phase_train_cross_check(torch, np, params, cpu_params,
                            unfreeze_vit: bool = False) -> None:
    """deer_3b at W=2, one trajectory: a joint-phase train step in fp32 on
    the card against fp32 on the CPU (the same weights, batch and layer
    draws; no dropout): the loss, every trainable gradient and every
    updated param.  With ``unfreeze_vit`` (phase ``train_unfreeze_vit``)
    the ViT trains too, through K1 and K1's backward on the card: both
    must launch, once a ViT layer.  The decoder's and the ViT's depths are
    ``params``'."""
    from deer_vla_tpu_torch.core.config import FP32, deer_3b
    phase = "train_unfreeze_vit" if unfreeze_vit else "train_cross_check"
    depth = len(params["decoder"]["blocks"])
    vit_depth = len(params["vit"]["blocks"])
    cfg2 = deer_3b(max_layer=depth, window_size=CALIB_CROSS_WINDOW,
                   dtypes=FP32)
    cfg2 = dataclasses.replace(cfg2, unfreeze_vit=unfreeze_vit,
                               vit=dataclasses.replace(cfg2.vit,
                                                       layers=vit_depth))
    cfg2, batch, draws = train_inputs(torch, cfg2, torch.device("cuda"))
    counters = reset_launches()
    card = train_step_parts(torch, params, cfg2, batch, draws, True)
    launches = launches_of(counters)
    vit_keys = [k for k in card[1] if k.startswith("vit/")]
    check(bool(vit_keys) == unfreeze_vit,
          f"{phase}: {len(vit_keys)} ViT leaves trained")
    check(launches["flash_attention"] == vit_depth
          and launches["flash_attention_backward"]
          == (vit_depth if unfreeze_vit else 0),
          f"{phase}: K1 launches {launches}")
    t0 = time.perf_counter()
    cpu = train_step_parts(torch, cpu_params, cfg2,
                           {k: v.cpu() for k, v in batch.items()}, draws,
                           False)
    cpu_s = time.perf_counter() - t0

    def rel_l2(a, b):
        return float(torch.linalg.vector_norm((a - b).double())
                     / max(float(torch.linalg.vector_norm(b.double())),
                           1e-30))

    loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    grad_rel = {k: rel_l2(g, cpu[1][k]) for k, g in card[1].items()}
    worst_param, param_rel = 0.0, {}
    for k, p in card[2].items():
        want, before = cpu[2][k], card[3][k]
        err = float(torch.linalg.vector_norm((p - want).double()))
        scale = (TRAIN_TOL_FP32["param_rel_l2"]
                 * float(torch.linalg.vector_norm(want.double()))
                 + TRAIN_TOL_FP32["grad_rel_l2"]
                 * float(torch.linalg.vector_norm((want - before).double())))
        worst_param = max(worst_param, err / max(scale, 1e-30))
        param_rel[k] = err / max(
            float(torch.linalg.vector_norm(want.double())), 1e-30)
    worst = max(grad_rel, key=grad_rel.get)
    moved = sum(not torch.equal(p, card[3][k]) for k, p in card[2].items())
    emit({"phase": phase, "config": f"deer_3b W=2 B=1 fp32, {depth} "
                                    f"layers, a {vit_depth}-layer ViT",
          "launches": launches, "vit_leaves": len(vit_keys),
          "loss": {"card": card[0], "cpu": cpu[0], "rel": loss_rel},
          "grad_leaves": len(grad_rel), "grad_worst": [worst,
                                                       grad_rel[worst]],
          "param_err_over_bound": worst_param,
          "param_worst_rel_l2": max(param_rel.items(), key=lambda kv: kv[1]),
          "params_moved": moved,
          "tol_fp32": TRAIN_TOL_FP32, "cpu_seconds": cpu_s})
    check(np.isfinite(card[0]) and loss_rel <= TRAIN_TOL_FP32["loss_rel"],
          f"{phase}: loss {card[0]} vs {cpu[0]}")
    check(grad_rel[worst] <= TRAIN_TOL_FP32["grad_rel_l2"],
          f"{phase}: grad {worst} rel {grad_rel[worst]}")
    check(worst_param <= 1.0, f"{phase}: params {worst_param}")
    check(moved > 0, f"{phase}: no param moved")


# --unfreeze_vit, card against CPU: the full-width ViT-L trained through K1's
# backward in fp32, under a decoder cut to 2 of its 12 layers, the ViT cut
# to 8 of its 24 (the CPU's fp32 step and update take most of the phase's
# time)
UNFREEZE_DEPTH = 2
UNFREEZE_VIT_DEPTH = 8


def phase_train_unfreeze_vit(torch, np) -> None:
    """``phase_train_cross_check`` with the ViT trained, on seeded deer_3b
    weights of ``UNFREEZE_DEPTH`` decoder layers and the ViT's first
    ``UNFREEZE_VIT_DEPTH``."""
    from deer_vla_tpu_torch.bridge import to_torch
    from deer_vla_tpu_torch.core.config import deer_3b
    params = build_weights(torch, deer_3b(max_layer=UNFREEZE_DEPTH))
    params["vit"]["blocks"] = params["vit"]["blocks"][:UNFREEZE_VIT_DEPTH]
    cpu_params = to_torch(params, "cpu")
    phase_train_cross_check(torch, np, params, cpu_params, unfreeze_vit=True)
    del params, cpu_params
    released_gb(torch)


@contextlib.contextmanager
def on_update(hook):
    """While open, calls ``hook(grads, loss, metrics)`` after each optimizer
    update of ``make_train_step``'s step (``metrics`` the update's own)."""
    from deer_vla_tpu_torch.train import train_step
    real = train_step._apply_update

    def wrapped(optimizer, state, grads, loss, metrics, *rest):
        out = real(optimizer, state, grads, loss, metrics, *rest)
        hook(grads, loss, out[1])
        return out

    train_step._apply_update = wrapped
    try:
        yield
    finally:
        train_step._apply_update = real


def train_updates(steps: list):
    """A context that records each optimizer update of the train step: when
    it ended (synchronised), the phase's trainable keys, which leaves got a
    nonzero gradient and which one above Adam's eps, the loss.  The
    bookkeeping's own time is recorded apart."""
    from deer_vla_tpu_torch.train.optimizer import EPS
    import torch

    def record(grads, loss, metrics):
        torch.cuda.synchronize()
        t = time.perf_counter()
        peak = torch.stack([g.abs().amax().float() for g in grads.values()])
        peak = dict(zip(grads, peak.cpu().tolist()))
        steps.append({"t": t, "keys": set(grads),
                      "nonzero": {k for k, v in peak.items() if v > 0},
                      "above_eps": {k for k, v in peak.items() if v > EPS},
                      "loss": float(loss),
                      "grad_norm": float(metrics["grad_norm"]),
                      "bookkeeping_s": time.perf_counter() - t})

    return on_update(record)


def phase_train(torch, np) -> dict:
    """``cli/train.main`` in-process on the card: deer_3b (bf16, fp32
    masters of the trainable leaves, bf16 frozen leaves), 1 joint and 1
    exit-only epoch of 4 DebugBatcher batches of 6 trajectories, W=12.
    Checks every loss is finite, K1 ran 24 times a step and K2-K4 never,
    the frozen leaves are bit for bit a fresh draw of the seed (the
    backbone an evaluation rebuilds), every joint-trainable leaf with a
    gradient moved in the joint phase (deer_0.ckpt against the fresh
    draw), and the exit-only phase moved head leaves only (the final
    params against deer_0.ckpt).  "With a gradient" is a gradient above
    Adam's eps (1e-8) in some step: Adam scales a smaller one down by
    |g| / (|g| + eps), and the update can round away on a leaf near 1
    (a LayerNorm scale).  With the init's x-attn gates at 0 and step 0's
    lr at 0, the x-attn internals see their first gradients in step 2 of
    the joint phase."""
    import io
    from deer_vla_tpu_torch.cli import train as cli
    from deer_vla_tpu_torch.models.flamingo import (cast_frozen_to_bf16,
                                                    init_deer,
                                                    trainable_mask)
    from deer_vla_tpu_torch.ops.layers import (flat_key,
                                               tree_leaves_with_path)
    from deer_vla_tpu_torch.train.checkpoint import load_checkpoint
    from deer_vla_tpu_torch.train.optimizer import flat_leaves
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    held_gb = released_gb(torch)
    torch.cuda.reset_peak_memory_stats()
    steps, buf = [], io.StringIO()
    t0 = time.perf_counter()
    with train_updates(steps), contextlib.redirect_stdout(buf):
        trainer = cli.main(TRAIN_ARGV)
    seconds = time.perf_counter() - t0
    launches = {n: f.launches for n, f in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "cli_train.log").write_text(buf.getvalue())
    cfg = trainer.cfg
    check(len(steps) == TRAIN_STEPS, f"train: {len(steps)} steps")
    check(all(np.isfinite(s["loss"]) for s in steps),
          f"train: losses {[s['loss'] for s in steps]}")
    check(launches["flash_attention"] == VIT_LAYERS * TRAIN_STEPS,
          f"train: K1 launched {launches['flash_attention']} times")
    check(all(launches[n] == 0 for n in DECODER_KERNEL.values()),
          f"train: K2-K4 launched: {launches}")

    with torch.no_grad():
        fresh = init_deer(cfg, seed=trainer.tcfg.seed, device="cuda")
        fresh = cast_frozen_to_bf16(fresh, trainable_mask(fresh, cfg,
                                                          "joint"))
    final = flat_leaves(trainer.params)
    start = flat_leaves(fresh)
    joint_end = flat_leaves(load_checkpoint(
        str(TRAIN_DIR / "deer_0.ckpt"), trainer.params)[0])
    joint_mask = {flat_key(p): m for p, m in tree_leaves_with_path(
        trainable_mask(fresh, cfg, "joint"))}
    frozen_changed = [k for k, m in joint_mask.items()
                      if not m and not torch.equal(final[k], start[k])]
    check(not frozen_changed, f"train: frozen leaves changed: "
                              f"{frozen_changed[:5]}")
    joint_steps, exit_steps = steps[:TRAIN_STEPS // 2], steps[TRAIN_STEPS // 2:]
    joint_grad = set().union(*(s["above_eps"] for s in joint_steps))
    joint_nonzero = set().union(*(s["nonzero"] for s in joint_steps))
    joint_keys = joint_steps[0]["keys"]
    unmoved = [k for k in joint_grad
               if torch.equal(joint_end[k], start[k])]
    check(not unmoved, f"train: joint leaves with a gradient did not "
                       f"move: {unmoved[:5]}")
    exit_keys = exit_steps[0]["keys"]
    heads = {"lm_head", "extra_exit", "lm_exits"}
    check(all(k.split("/")[0] in heads for k in exit_keys),
          "train: the exit-only phase trains non-head leaves")
    exit_grad = set().union(*(s["above_eps"] for s in exit_steps))
    exit_nonzero = set().union(*(s["nonzero"] for s in exit_steps))
    moved_in_exit = {k for k in final if not torch.equal(final[k],
                                                         joint_end[k])}
    check(moved_in_exit <= exit_keys and exit_grad <= moved_in_exit,
          f"train: exit-only moved {sorted(moved_in_exit - exit_keys)[:5]}, "
          f"left {sorted(exit_grad - moved_in_exit)[:5]}")
    secs = step_intervals(steps)
    files = {f.name: f.stat().st_size for f in sorted(TRAIN_DIR.iterdir())}
    out = {"phase": "train", "argv": TRAIN_ARGV, "seconds": seconds,
           "steps": len(steps), "losses": [s["loss"] for s in steps],
           "grad_norms": [s["grad_norm"] for s in steps],
           # warm medians: a phase's first step is not in its list
           "joint_step_s_median": statistics.median(secs[:3]),
           "exit_step_s_median": statistics.median(secs[4:]),
           "step_s": secs, "peak_memory_gb": peak_gb,
           "allocated_before_gb": held_gb,
           "trainable_joint": len(joint_keys),
           "joint_no_gradient": len(joint_keys - joint_nonzero),
           "joint_gradient_below_eps": len(joint_nonzero - joint_grad),
           "joint_below_eps_unmoved": sum(
               torch.equal(joint_end[k], start[k])
               for k in joint_nonzero - joint_grad),
           "trainable_exit_only": len(exit_keys),
           "exit_no_gradient": len(exit_keys - exit_nonzero),
           "exit_gradient_below_eps": len(exit_nonzero - exit_grad),
           "frozen_leaves": sum(not m for m in joint_mask.values()),
           "checkpoint_files": files, "launches": launches}
    emit(out)
    del trainer, fresh, final, start, joint_end
    torch.cuda.empty_cache()
    return out


def phase_train_eval(torch, np) -> dict:
    """``cli/eval --evaluate_from_checkpoint`` on the training run's last
    checkpoint, in-process on the card: the delta overlays the rebuilt
    backbone (every stored leaf consumed), then calibration and 2 DebugEnv
    rollout sequences with K1 and K2 counted; then the same with
    ``--layerwise_exit_eval`` (each exit's own trained head, on the
    host-bucketed engine: ``phase_rollout``'s checks)."""
    import io
    import warnings
    from deer_vla_tpu_torch.cli import eval as cli
    ckpt = str(TRAIN_DIR / "deer_1.ckpt")
    argv = ["--debug", "--model", "deer_3b", "--evaluate_from_checkpoint",
            ckpt, "--calib_batches", "2", "--num_sequences_override", "2",
            "--ep_len", "40", "--exit_ratio", "0.5"]
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught, \
            contextlib.redirect_stdout(buf):
        warnings.simplefilter("always")
        # the values sidecar beside the checkpoint, for phase serve_cli
        report = cli.main(argv + ["--value_cache", ckpt[:-len(".ckpt")]])
    seconds = time.perf_counter() - t0
    launches = {n: f.launches for n, f in counters.items()}
    text = buf.getvalue()
    (OUT_DIR / "cli_eval_from_checkpoint.log").write_text(text)
    loaded = re.search(r"loaded (\d+) param groups from ckpt", text)
    unmatched = [str(w.message) for w in caught
                 if "not matched" in str(w.message)]
    check(loaded and int(loaded.group(1)) > 0,
          "train_eval: no leaf loaded from the checkpoint")
    check(not unmatched, f"train_eval: unconsumed keys: {unmatched}")
    check(launches["flash_attention"] > 0 and launches["indexed_matmul"] > 0,
          f"train_eval: K1 / K2 not launched: {launches}")
    out = {"phase": "train_eval", "argv": argv, "seconds": seconds,
           "loaded_keys": int(loaded.group(1)), "unconsumed_keys": 0,
           "avg_seq_len": report["avg_seq_len"],
           "avg_exit_layer": report["avg_exit_layer"],
           "exit_hist": report["exit_hist"], "launches": launches}
    emit(out)
    # a cache of its own: it calibrates as the run above did, and leaves
    # that run's sidecar as it is
    layerwise = phase_rollout(torch, np, "train_eval_layerwise", argv + [
        "--layerwise_exit_eval", "--value_cache",
        str(TRAIN_DIR / "layerwise_values")])
    out["runs"] = {"layerwise": layerwise}
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the CALVIN phases
# ---------------------------------------------------------------------------


def read_ms(fn, reps: int = 10) -> float:
    """Host milliseconds of one ``fn()`` call, mean of ``reps`` after one."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


@contextlib.contextmanager
def numpy_reader():
    """While open, the datasets read their windows with ``np.load``: the
    native library is set aside as a failed build would leave it."""
    from deer_vla_tpu_torch.data import native_loader
    kept = native_loader._lib, native_loader._error
    native_loader._lib, native_loader._error = None, "set aside to time np.load"
    try:
        yield
    finally:
        native_loader._lib, native_loader._error = kept


def loader_batches_per_s(batches: int) -> float:
    """Batches a second of ``CalvinLoader`` over the training split at
    cli/train's defaults (B=6, W=12, 4 loader threads, prefetch 3), after
    its first batch."""
    from deer_vla_tpu_torch.data.calvin import (CalvinDataConfig,
                                                CalvinLoader,
                                                DiskCalvinDataset)
    from deer_vla_tpu_torch.data.text import HashTokenizer
    ds = DiskCalvinDataset(CalvinDataConfig(
        dataset_dir=str(CALVIN_DIR / "training"), window_size=12),
        validation=False)
    it = iter(CalvinLoader(ds, HashTokenizer(max_length=32), TRAIN_BATCH,
                           workers=4))
    next(it)
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    rate = batches / (time.perf_counter() - t0)
    it.close()
    return rate


def phase_calvin_data(np) -> dict:
    """Writes the CALVIN-format tree, holds the native reader against
    ``np.load`` bit for bit on a STORED and a DEFLATE window of 12 frames
    (CALVIN's five keys), times a window's read both ways (the dataset's
    four keys) and the loader's batches a second with either reader."""
    from deer_vla_tpu_torch.data import native_loader
    from deer_vla_tpu_torch.data.calvin import DiskCalvinDataset
    from deer_vla_tpu_torch.data.debug_data import make_synthetic_calvin
    shutil.rmtree(CALVIN_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    split_bytes = {}
    for i, (split, (n, ep_len)) in enumerate(CALVIN_SPLITS.items()):
        d = make_synthetic_calvin(str(CALVIN_DIR), n_episodes=n,
                                  ep_len=ep_len, img_hw=200, grip_hw=84,
                                  split=split, seed=SEED + i,
                                  compressed_episodes=set(range(1, n, 2)))
        split_bytes[split] = sum(f.stat().st_size
                                 for f in Path(d).glob("episode_*.npz"))
    write_s = time.perf_counter() - t0
    native_loader.reset_counts()
    t0 = time.perf_counter()
    status = native_loader.status()  # builds the reader
    build_s = time.perf_counter() - t0
    check(status["available"],
          f"calvin_data: the native reader did not build: {status['error']}")
    train = CALVIN_DIR / "training"
    ep_len = CALVIN_SPLITS["training"][1]
    windows = {"stored": range(0, 12), "deflate": range(ep_len, ep_len + 12)}
    keys = DiskCalvinDataset.EPISODE_KEYS
    reads = {}
    for kind, frames in windows.items():
        paths = [str(train / f"episode_{i:07d}.npz") for i in frames]
        got = native_loader.read_window_keys(paths, CALVIN_KEYS)
        check(got is not None, f"calvin_data: no native read of {kind}")
        loaded = [np.load(p) for p in paths]
        for k in CALVIN_KEYS:
            want = np.stack([f[k] for f in loaded])
            check(got[k].dtype == want.dtype and np.array_equal(got[k], want),
                  f"calvin_data: {kind} {k} differs from np.load")

        def numpy_window():
            fs = [np.load(p) for p in paths]
            return {k: np.stack([f[k] for f in fs]) for k in keys}

        reads[kind] = {
            "native_ms": read_ms(lambda: native_loader.read_window_keys(
                paths, keys)),
            "numpy_ms": read_ms(numpy_window)}
        reads[kind]["speedup"] = (reads[kind]["numpy_ms"]
                                  / reads[kind]["native_ms"])
    native_loader.reset_counts()
    rates = {"native": loader_batches_per_s(8)}
    with numpy_reader():
        rates["numpy"] = loader_batches_per_s(8)
    rates["native_again"] = loader_batches_per_s(8)
    served = native_loader.status()
    check(served["native_windows"] > 0 and served["numpy_windows"] > 0,
          f"calvin_data: windows served {served}")
    out = {"phase": "calvin_data", "root": str(CALVIN_DIR),
           "splits": {k: {"episodes": n, "frames_each": e,
                          "bytes": split_bytes[k],
                          "compressed_episodes": list(range(1, n, 2))}
                      for k, (n, e) in CALVIN_SPLITS.items()},
           "write_s": write_s, "reader_build_s": build_s,
           "reader_status": status, "window_read": reads,
           "loader_batches_per_s": rates, "loader_reader": served}
    emit(out)
    return out


class TimedLoader:
    """The trainer's loader, with the seconds the step loop waited for each
    batch (the first one includes starting the loader)."""

    def __init__(self, loader):
        self.loader = loader
        self.waits = []

    def set_epoch(self, epoch: int):
        self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.waits.append(time.perf_counter() - t0)
            yield batch


def run_calvin_training(torch, argv, save_last: bool):
    """cli/train's trainer for ``argv``, built and run on the card as
    ``cli.train.main`` runs it, each optimizer update recorded, the loader
    timed and the kernels and readers counted from 0; no epoch checkpoint
    is written, and with ``save_last`` the last epoch is saved once at the
    end.  Returns (trainer, record)."""
    import io
    from deer_vla_tpu_torch.cli import train as cli
    from deer_vla_tpu_torch.data import native_loader
    held_gb = released_gb(torch)
    trainer, _ = cli.build_trainer(argv)
    trainer.tcfg = dataclasses.replace(trainer.tcfg, save_every_epoch=False)
    loader = trainer.loader = TimedLoader(trainer.loader)
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    native_loader.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps, buf = [], io.StringIO()
    t0 = time.perf_counter()
    with train_updates(steps), contextlib.redirect_stdout(buf):
        trainer.train()
    seconds = time.perf_counter() - t0
    record = {"seconds": seconds, "steps": steps,
              "launches": {n: f.launches for n, f in counters.items()},
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "allocated_before_gb": held_gb,
              "loader_waits_s": loader.waits,
              "reader": native_loader.status(), "log": buf.getvalue()}
    if save_last:
        t0 = time.perf_counter()
        path = trainer.save(trainer.tcfg.num_epochs - 1)
        record["checkpoint"] = {"path": path,
                                "seconds": time.perf_counter() - t0,
                                "bytes": Path(path).stat().st_size}
    return trainer, record


def step_intervals(steps: list) -> list:
    """Seconds between consecutive optimizer updates, less the recording's
    own time."""
    ends = [s["t"] for s in steps]
    book = [s["bookkeeping_s"] for s in steps]
    return [ends[i] - ends[i - 1] - book[i - 1] for i in range(1, len(ends))]


def check_training(np, name: str, record: dict, n_steps: int) -> None:
    steps, launches = record["steps"], record["launches"]
    check(len(steps) == n_steps, f"{name}: {len(steps)} steps")
    check(all(np.isfinite(s["loss"]) for s in steps),
          f"{name}: losses {[s['loss'] for s in steps]}")
    check(launches["flash_attention"] == VIT_LAYERS * n_steps,
          f"{name}: K1 launched {launches['flash_attention']} times")
    check(all(launches[n] == 0 for n in DECODER_KERNEL.values()),
          f"{name}: K2-K4 launched: {launches}")
    check(record["reader"]["native_windows"] > 0
          and record["reader"]["numpy_windows"] == 0,
          f"{name}: windows served {record['reader']}")


def phase_train_calvin(torch, np) -> dict:
    """cli/train on the CALVIN tree (deer_3b, bf16, B=6, W=12, rgb_pad 10,
    gripper_pad 4): 1 joint and 1 exit-only epoch of 4 batches, one
    checkpoint (the last epoch's).  Checks the losses, K1 24 times a step
    and K2-K4 never, every window read natively, the frozen leaves bit for
    bit a fresh draw of the seed, every joint leaf with a gradient above
    Adam's eps moved, and the exit-only phase trained head leaves only."""
    from deer_vla_tpu_torch.models.flamingo import (cast_frozen_to_bf16,
                                                    init_deer,
                                                    trainable_mask)
    from deer_vla_tpu_torch.ops.layers import (flat_key,
                                               tree_leaves_with_path)
    from deer_vla_tpu_torch.train.optimizer import flat_leaves
    shutil.rmtree(CALVIN_RUN, ignore_errors=True)
    trainer, r = run_calvin_training(torch, CALVIN_TRAIN_ARGV, True)
    (OUT_DIR / "cli_train_calvin.log").write_text(r.pop("log"))
    n = len(trainer.loader)
    check(n == 4, f"train_calvin: {n} batches an epoch")
    check_training(np, "train_calvin", r, 2 * n)
    steps = r.pop("steps")
    cfg = trainer.cfg
    with torch.no_grad():
        fresh = init_deer(cfg, seed=trainer.tcfg.seed, device="cuda")
        fresh = cast_frozen_to_bf16(fresh, trainable_mask(fresh, cfg,
                                                          "joint"))
    final, start = flat_leaves(trainer.params), flat_leaves(fresh)
    joint_mask = {flat_key(p): m for p, m in tree_leaves_with_path(
        trainable_mask(fresh, cfg, "joint"))}
    frozen_changed = [k for k, m in joint_mask.items()
                      if not m and not torch.equal(final[k], start[k])]
    check(not frozen_changed, f"train_calvin: frozen leaves changed: "
                              f"{frozen_changed[:5]}")
    joint_grad = set().union(*(s["above_eps"] for s in steps[:n]))
    unmoved = [k for k in joint_grad if torch.equal(final[k], start[k])]
    check(not unmoved, f"train_calvin: joint leaves with a gradient did "
                       f"not move: {unmoved[:5]}")
    heads = {"lm_head", "extra_exit", "lm_exits"}
    check(all(k.split("/")[0] in heads for k in steps[n]["keys"]),
          "train_calvin: the exit-only phase trains non-head leaves")
    secs = step_intervals(steps)
    waits = r.pop("loader_waits_s")
    out = {"phase": "train_calvin", "argv": CALVIN_TRAIN_ARGV,
           "batches_per_epoch": n, "losses": [s["loss"] for s in steps],
           "grad_norms": [s["grad_norm"] for s in steps],
           # warm medians: a phase's first step is not in its list
           "joint_step_s_median": statistics.median(secs[:n - 1]),
           "exit_step_s_median": statistics.median(secs[n:]),
           "step_s": secs, "loader_wait_s": waits,
           "loader_wait_s_warm_median": statistics.median(waits[1:]),
           "trainable_joint": len(steps[0]["keys"]),
           "joint_with_gradient_above_eps": len(joint_grad), **r}
    emit(out)
    del trainer, fresh, final, start
    torch.cuda.empty_cache()
    return out


def phase_train_calvin_difws(torch, np) -> dict:
    """cli/train --dif_ws at W=24 (288 ViT images a step), 1 joint epoch
    of 5 batches, without remat, with --remat and with --remat_policy dots:
    the same seeds and batches in each.  Checks each run as train_calvin,
    the losses of the remat runs against no remat (``DIFWS_LOSS_REL``) and
    the --remat (full) peak memory below no remat's."""
    runs = {}
    for name, extra in DIFWS_RUNS:
        trainer, r = run_calvin_training(torch, DIFWS_ARGV + extra, False)
        r.pop("log")
        check(trainer.cfg.window_size == 24
              and trainer.loader.loader.ds.cfg.max_window_size == 24
              and trainer.cfg.remat_layers == (name != "none")
              and (name == "none" or trainer.cfg.remat_policy == name),
              f"train_calvin_difws {name}: config {trainer.cfg.remat_policy}")
        check_training(np, f"train_calvin_difws {name}", r, DIFWS_STEPS)
        steps = r.pop("steps")
        secs = step_intervals(steps)
        runs[name] = {"losses": [s["loss"] for s in steps],
                      "step_s": secs, "step_s_median": statistics.median(secs),
                      **r}
        del trainer
        torch.cuda.empty_cache()
    base = runs["none"]
    for name in ("full", "dots"):
        rel = max(abs(a - b) / abs(b) for a, b in zip(runs[name]["losses"],
                                                      base["losses"]))
        runs[name]["loss_max_rel_vs_none"] = rel
        runs[name]["peak_vs_none"] = (runs[name]["peak_memory_gb"]
                                      / base["peak_memory_gb"])
        check(rel <= DIFWS_LOSS_REL, f"train_calvin_difws {name}: losses "
              f"{runs[name]['losses']} vs {base['losses']}")
    check(runs["full"]["peak_memory_gb"] < base["peak_memory_gb"],
          f"train_calvin_difws: remat peak {runs['full']['peak_memory_gb']} "
          f"GB not below {base['peak_memory_gb']}")
    out = {"phase": "train_calvin_difws", "argv": DIFWS_ARGV,
           "loss_tolerance_rel": DIFWS_LOSS_REL, "runs": runs}
    emit(out)
    return out


def phase_calib_calvin(torch, np) -> dict:
    """cli/eval --calvin_dataset on train_calvin's checkpoint, without
    --debug: 2 validation batches of 6 trajectories (W=12, 144 ViT images
    each through K1), the values sidecar written, then the asserted
    dropped-env SystemExit; then cli/eval --debug on the same
    --value_cache stem, which must serve those values (no calibration)."""
    import io
    from deer_vla_tpu_torch.cli import eval as cli
    from deer_vla_tpu_torch.core.config import deer_3b
    from deer_vla_tpu_torch.data import native_loader
    from deer_vla_tpu_torch.train.checkpoint import load_calibration_values
    ckpt = str(CALVIN_RUN / "deer_1.ckpt")
    stem = str(CALVIN_DIR / "calvin_values")
    argv = ["--model", "deer_3b", "--calvin_dataset", str(CALVIN_DIR),
            "--evaluate_from_checkpoint", ckpt, "--value_cache", stem,
            "--batch_size_calvin", str(TRAIN_BATCH), "--calib_batches", "2",
            "--exit_ratio", "0.5"]
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    native_loader.reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    raised = None
    with contextlib.redirect_stdout(buf):
        try:
            cli.main(argv)
        except SystemExit as err:
            raised = str(err)
    seconds = time.perf_counter() - t0
    launches = {n: f.launches for n, f in counters.items()}
    reader = native_loader.status()
    text = buf.getvalue()
    (OUT_DIR / "cli_eval_calvin.log").write_text(text + f"\n{raised}\n")
    check(raised == cli.CALVIN_ENV_DROPPED,
          f"calib_calvin: ended with {raised!r}")
    values = load_calibration_values(stem)
    n_exits = len(deer_3b().all_exit_ids())
    check(values is not None and values.shape == (n_exits, 2 * TRAIN_BATCH * 6)
          and bool(np.isfinite(values).all()),
          f"calib_calvin: values {None if values is None else values.shape}")
    check(launches["flash_attention"] == 2 * VIT_LAYERS
          and all(launches[n] == 0 for n in DECODER_KERNEL.values()),
          f"calib_calvin: launches {launches}")
    check(reader["native_windows"] > 0 and reader["numpy_windows"] == 0,
          f"calib_calvin: windows served {reader}")
    thresholds = text.strip().splitlines()[-1]
    argv2 = ["--debug", "--model", "deer_3b", "--evaluate_from_checkpoint",
             ckpt, "--value_cache", stem, "--num_sequences_override", "2",
             "--ep_len", "40", "--exit_ratio", "0.5"]
    for f in counters.values():
        f.launches = 0
    buf2 = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf2):
        report = cli.main(argv2)
    seconds2 = time.perf_counter() - t0
    launches2 = {n: f.launches for n, f in counters.items()}
    text2 = buf2.getvalue()
    (OUT_DIR / "cli_eval_calvin_values.log").write_text(text2)
    check("reusing calibration values" in text2 and "calibrated" not in text2,
          "calib_calvin: the --debug run did not serve the cached values")
    check(text2.strip().splitlines()[-3] == thresholds,
          f"calib_calvin: thresholds {text2.strip().splitlines()[-3]} vs "
          f"{thresholds}")
    out = {"phase": "calib_calvin", "argv": argv, "seconds": seconds,
           "raised": raised, "values_shape": list(values.shape),
           "values_median": float(np.median(values)),
           "thresholds": thresholds, "launches": launches,
           "loader_reader": reader, "debug_argv": argv2,
           "debug_seconds": seconds2, "debug_launches": launches2,
           "avg_seq_len": report["avg_seq_len"],
           "avg_exit_layer": report["avg_exit_layer"]}
    emit(out)
    shutil.rmtree(CALVIN_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# deer_9b (MPT-7B, x-attn every 4 layers) and bc_llama, after deer_3b's
# phases have freed their weights
# ---------------------------------------------------------------------------

# the 9B and llama serve phases sweep from -1 (no early exit: full depth)
# to 1e8 (the first exit fires), so both early and full-depth exits occur
# whatever these weights' deltas are
SWEEP_9B = [-1.0, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1e8]
ROLLOUT_9B_ARGV = ["--debug", "--model", "mpt_9b"] + ROLLOUT_ARGV[3:]
# bc_llama's preset depth (cli/eval cuts every model to 12 layers unless
# --max_layer says otherwise)
LLAMA_DEPTH = 32
ROLLOUT_LLAMA_ARGV = (["--debug", "--model", "llama_9b", "--max_layer",
                       str(LLAMA_DEPTH)] + ROLLOUT_ARGV[3:])


def phase_weights(torch, cfg, name: str):
    """Seeded weights of ``cfg`` on the card, their size and the seconds
    the draw took."""
    from deer_vla_tpu_torch.ops.layers import tree_leaves_with_path
    from deer_vla_tpu_torch.ops.quant import tree_bytes
    gb = released_gb(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = build_weights(torch, cfg)
    torch.cuda.synchronize()
    emit({"phase": name, "seconds": time.perf_counter() - t0, "seed": SEED,
          "held_before_gb": gb, "mpt": [cfg.n_layers, cfg.mpt.d_model,
                                        cfg.mpt.n_heads, cfg.mpt.arch],
          "xattn_layers": [i for i in range(cfg.n_layers)
                           if cfg.has_xattn(i)],
          "exits": list(cfg.all_exit_ids()),
          "params": sum(t.numel() for _, t in tree_leaves_with_path(params)),
          "params_bytes": tree_bytes(params),
          "decoder_blocks_bytes": tree_bytes(params["decoder"]["blocks"]),
          "xattn_bytes": tree_bytes(params["decoder"]["xattn"])})
    return params


def phase_cross_check_plain_quantized(torch, np, cfg, params,
                                      name: str) -> None:
    """int8 and int4 in fp32 on the card: one full-depth step through K3 /
    K4 against the same codes through their plain products (``linear`` on
    each layer's slice), within CROSS_TOL_FP32."""
    from deer_vla_tpu_torch.core.config import FP32
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    cfg32 = dataclasses.replace(cfg, dtypes=FP32)
    inputs = make_policy_inputs(np, cfg, 1, seed=300)
    for mode in ("int8", "int4"):
        steps = []
        for imm in (True, False):
            pol = ScanDeerPolicy(params, cfg32, indexed_mm=imm,
                                 quantize=mode)
            steps.append(full_depth_step(np, pol, cfg32, inputs))
            del pol
            torch.cuda.empty_cache()
        got = compare(np, torch, *steps[0], *steps[1])
        emit({"phase": f"{name}_{mode}", "exit_layer": cfg.n_layers - 1,
              "kernel_fp32_vs_plain_fp32": got, "tol_fp32": CROSS_TOL_FP32})
        for key, limit in CROSS_TOL_FP32.items():
            check(got[key] <= limit, f"{name} {mode} {key} {got[key]}")


def calibrate_launches(calib: dict) -> dict:
    return {name: sum(b[name] for r in calib["regimes"].values()
                      for b in r["launches_per_batch"])
            for name in kernel_counters()}


# cross_check_9b's depth: deer_9b's first 4 layers (cross-attention on
# layer 3, the exit at 3)
CROSS_DEPTH_9B = 4


def drive_9b(torch, np) -> tuple:
    """deer_9b at full width and its preset depth (12 layers, d_model
    4096, exits [3, 7, 11]) from seeded weights: ``ScanDeerPolicy`` with K2
    in every serving mode, ``DeerPolicy`` against the scan engine's plain
    products, a full-depth step of the draw's first ``CROSS_DEPTH_9B``
    layers against fp32 on the CPU, K3 / K4 against their plain products,
    calibration, then ``cli/eval --debug --model mpt_9b``.  Before the
    cross-checks, tp_serve_9b's one-process reference
    (``tp_serve_reference``), which ``phase_tp`` holds the four ranks
    to."""
    from deer_vla_tpu_torch.bridge import to_torch
    from deer_vla_tpu_torch.core.config import deer_9b
    from deer_vla_tpu_torch.eval.policy import DeerPolicy
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    from deer_vla_tpu_torch.models.value_net import ExitController
    cfg = deer_9b()
    params = phase_weights(torch, cfg, "weights_9b")
    pol = ScanDeerPolicy(params, cfg, indexed_mm=True)
    serve = phase_serve(torch, np, cfg, pol, name="serve_9b",
                        config="deer_9b", sweep=SWEEP_9B)
    quantized = phase_serve_quantized(torch, np, cfg, params,
                                      serve["stacked_bytes"],
                                      config="deer_9b", sweep=SWEEP_9B,
                                      prefix="serve_9b")
    tp_ref = tp_serve_reference(torch, np, cfg, params, pol)
    deer = DeerPolicy(params, cfg, controller=ExitController(
        exit_id_list=list(cfg.all_exit_ids()), max_layer=cfg.n_layers))
    scan_plain = ScanDeerPolicy(params, cfg)
    bucketed = phase_serve_bucketed(torch, np, cfg, deer, scan_plain, serve,
                                    name="serve_9b_bucketed",
                                    config="deer_9b", sweep=SWEEP_9B)
    del deer, scan_plain, pol
    torch.cuda.empty_cache()
    # against fp32 on the CPU: the draw's first CROSS_DEPTH_9B layers
    cfg_cut = cut_depth(cfg, CROSS_DEPTH_9B)
    params_cut = first_layers(params, cfg_cut)
    cpu_params = to_torch(params_cut, "cpu")
    pol = ScanDeerPolicy(params_cut, cfg_cut, indexed_mm=True)
    phase_cross_check(torch, np, cfg_cut, params_cut, cpu_params, pol,
                      name="cross_check_9b")
    del cpu_params, pol, params_cut
    gc.collect()
    torch.cuda.empty_cache()
    phase_cross_check_plain_quantized(torch, np, cfg, params,
                                      "cross_check_9b")
    calib = phase_calibrate(torch, np, cfg, params, name="calibrate_9b",
                            model="mpt_9b")
    del params
    released_gb(torch)
    rollout = phase_rollout(torch, np, "rollout_9b", ROLLOUT_9B_ARGV)
    return ([serve, bucketed, rollout] + list(quantized.values()),
            {"calibrate_9b": calibrate_launches(calib)}, tp_ref)


def drive_llama(torch, np) -> list:
    """bc_llama at full width (d_model 4096, 32 heads, SwiGLU 11008) and
    its preset depth of 32 layers: ``ScanDeerPolicy`` (``linear`` on each
    layer's slice: none of K2-K4, K1 24 times a step) in bf16 and int8 at
    B=1 / B=8, a full-depth bf16 step against fp32 on the card, then
    ``cli/eval --debug --model llama_9b`` at the same depth."""
    from deer_vla_tpu_torch.core.config import FP32, bc_llama
    from deer_vla_tpu_torch.data.text import HashTokenizer
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    cfg = bc_llama(n_layers=LLAMA_DEPTH)
    # the preset keeps MPT's media token id (50277), outside llama's 32000
    # ids: take the debug tokenizer's, as cli/eval does
    tok = HashTokenizer(vocab_size=cfg.mpt.vocab_size, max_length=cfg.text_len)
    cfg = dataclasses.replace(cfg, media_token_id=tok.media_token_id)
    params = phase_weights(torch, cfg, "weights_llama")
    pol = ScanDeerPolicy(params, cfg)
    serve = phase_serve(torch, np, cfg, pol, name="serve_llama",
                        config="bc_llama", sweep=SWEEP_9B)
    inputs = make_policy_inputs(np, cfg, 1, seed=300)
    act_bf16, hid_bf16 = full_depth_step(np, pol, cfg, inputs)
    del pol
    torch.cuda.empty_cache()
    quantized = phase_serve_quantized(torch, np, cfg, params,
                                      serve["stacked_bytes"],
                                      modes=(("int8", 8),),
                                      config="bc_llama", sweep=SWEEP_9B,
                                      prefix="serve_llama")
    cfg32 = dataclasses.replace(cfg, dtypes=FP32)
    card32 = ScanDeerPolicy(params, cfg32)
    act32, hid32 = full_depth_step(np, card32, cfg32, inputs)
    del card32, params
    got = compare(np, torch, act_bf16, hid_bf16, act32, hid32)
    emit({"phase": "cross_check_llama", "exit_layer": cfg.n_layers - 1,
          "card_bf16_vs_card_fp32": got, "tol_bf16": CROSS_TOL_BF16,
          "fp32": "the plain fp32 path on the card (cuBLAS products, K1's "
                  "fp32 path in the ViT)",
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    for key, limit in CROSS_TOL_BF16.items():
        check(got[key] <= limit, f"cross_check_llama {key} {got[key]}")
    released_gb(torch)
    rollout = phase_rollout(torch, np, "rollout_llama", ROLLOUT_LLAMA_ARGV)
    return [serve, rollout] + list(quantized.values())


def tome_rows(rows: list) -> list:
    """K1 at the ToMe shapes, one entry a query length."""
    return [{"sq": r["shape"][2], "ms": r["kernel_ms"],
             "plain_ms": r["reference_ms"], "library_ms": r["library_ms"],
             "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
             "max_abs_err": r["max_abs_err"]} for r in rows]


def kernels_line(summary: dict, launches: dict, tc: dict,
                 path_launches: dict) -> dict:
    """``launches`` maps each kernel to its count on the serve path that
    runs it: K1 and K2 on the bf16 serve, K3 on int8's, K4 on int4's (and
    ``<name>_9b`` on deer_9b's); ``path_launches`` holds every kernel's
    count on the calibration, rollout, training, 9B and llama paths, by
    path."""
    k1 = summary["flash_attention"]
    out = [{"name": "flash_attention", "route": "cuda",
            "source": "deer_vla_tpu_torch/csrc/flash_attention.cu",
            "replaces": "deer_vla_tpu/ops/pallas/flash_attention.py:109",
            "launches": launches["flash_attention"],
            "max_abs_err": k1["max_abs_err"], "tolerance": k1["tolerance"],
            "ms": k1["kernel_ms"], "plain_ms": k1["reference_ms"],
            "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
            "library_ms": k1["library_ms"], "bytes": k1["bytes"],
            "flops": k1["flops"],
            "b8_ms": summary["flash_attention_b8"]["kernel_ms"],
            "b8_library_ms": summary["flash_attention_b8"]["library_ms"],
            "calib_ms": summary["flash_attention_calib"]["kernel_ms"],
            "calib_plain_ms": summary["flash_attention_calib"]["reference_ms"],
            "calib_library_ms": summary["flash_attention_calib"]["library_ms"],
            "calib_bound_ms": summary["flash_attention_calib"]["bound_ms"],
            "calib_shape": "q,k,v (48,16,257,64) bf16 strided views of a "
                           "fused qkv (ViT layer of a calibration batch)",
            "train_ms": summary["flash_attention_train"]["kernel_ms"],
            "train_plain_ms": summary["flash_attention_train"]["reference_ms"],
            "train_library_ms": summary["flash_attention_train"]["library_ms"],
            "train_bound_ms": summary["flash_attention_train"]["bound_ms"],
            "train_max_abs_err":
                summary["flash_attention_train"]["max_abs_err"],
            "train_shape": "q,k,v (144,16,257,64) bf16 strided views of a "
                           "fused qkv (ViT layer of a training batch)",
            "difws_ms": summary["flash_attention_difws"]["kernel_ms"],
            "difws_plain_ms": summary["flash_attention_difws"]["reference_ms"],
            "difws_library_ms": summary["flash_attention_difws"]["library_ms"],
            "difws_bound_ms": summary["flash_attention_difws"]["bound_ms"],
            "difws_max_abs_err":
                summary["flash_attention_difws"]["max_abs_err"],
            "difws_shape": "q,k,v (288,16,257,64) bf16 strided views of a "
                           "fused qkv (ViT layer of a --dif_ws W=24 batch)",
            "folded_ms": summary["flash_attention_folded"]["kernel_ms"],
            "folded_plain_ms":
                summary["flash_attention_folded"]["reference_ms"],
            "folded_library_ms":
                summary["flash_attention_folded"]["library_ms"],
            "folded_bound_ms": summary["flash_attention_folded"]["bound_ms"],
            "folded_b8_ms": summary["flash_attention_folded_b8"]["kernel_ms"],
            "folded_b8_plain_ms":
                summary["flash_attention_folded_b8"]["reference_ms"],
            "folded_b8_library_ms":
                summary["flash_attention_folded_b8"]["library_ms"],
            "folded_b8_bound_ms":
                summary["flash_attention_folded_b8"]["bound_ms"],
            "folded_shape": "q,k,v (24 | 192,16,257,64) bf16 strided views "
                            "(ViT layer of a W=12 window-folded step, B=1 "
                            "| B=8, uncached)",
            "tensor_core_sass": tc["flash_attention"]["hmma_hgmma"],
            "shape": "q,k,v (2,16,257,64) bf16, no bias (ViT layer, B=1)",
            "tome_shape": f"ToMe r={TOME_R}: q,k,v (2B,16,Sq,64) bf16 "
                          "strided, Sk = Sq, bias (2B,1,Sq,Sq) fp32 "
                          "(stride 0 along Sq), B=1 and a calibration "
                          "batch (B=24)",
            "tome_b1": tome_rows(summary["flash_attention_tome"]),
            "tome_calib": tome_rows(summary["flash_attention_tome_calib"])}]
    for name, source, line, weights, library in (
            ("indexed_matmul", "indexed_matmul.cu", 289,
             "W (12, K, N) bf16", "x @ W[i]"),
            ("indexed_matmul_q8", "indexed_matmul_quant.cu", 153,
             "Wq (12, K, N) int8, s (12, N) fp32",
             "x @ Wd[i], Wd dequantized to bf16 beforehand"),
            ("indexed_matmul_q4", "indexed_matmul_quant.cu", 258,
             "Wq4 (12, K/2, N) packed int4, s (12, N) fp32",
             "x @ Wd[i], Wd dequantized to bf16 beforehand")):
        k = summary[name]
        out.append({
            "name": name, "route": "cuda",
            "source": f"deer_vla_tpu_torch/csrc/{source}",
            "replaces": f"deer_vla_tpu/ops/pallas/indexed_matmul.py:{line}",
            "launches": launches[name], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"], "library": library,
            "bytes": k["bytes"], "flops": k["flops"],
            "shape": f"one decoder layer's four products, x (32, K) bf16, "
                     f"{weights}, B=1"})
    for tag in ("hist", "hist_b8"):
        k = summary["indexed_matmul_" + tag]
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "max_abs_err"):
            out[1][f"{key}_{tag}"] = k[key]
    out[1]["shape_hist"] = ("one decoder layer's four products, x (384 | "
                            "3072, K) bf16: use_hist's W=12 text rows a "
                            "stream, B=1 | B=8")
    for row in out[1:]:
        b8 = summary[row["name"] + "_b8"]
        row["b8_ms"] = b8["ms"]
        row["b8_library_ms"] = b8["library_ms"]
        row["b8_bound_ms"] = b8["bound_ms"]
        row["tensor_core_sass"] = tc[row["name"]]["hmma_hgmma"]
        row["conversion_sass"] = tc[row["name"]]["conversions"]
        for tag in ("9b", "9b_b8"):
            k = summary[row["name"] + "_" + tag]
            for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_by", "max_abs_err"):
                row[f"{key}_{tag}"] = k[key]
        row["launches_9b"] = launches[row["name"] + "_9b"]
        for tag in ("9b_tp4", "9b_tp4_b8"):
            k = summary[row["name"] + "_" + tag]
            for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_by", "max_abs_err"):
                row[f"{key}_{tag}"] = k[key]
        # the four ranks' launches on tp_serve_9b's path, in its mode
        row["launches_9b_tp4"] = launches[row["name"] + "_9b_tp4"]
        row["shape_9b_tp4"] = ("one tp=4 rank's local stacks of a deer_9b "
                               "layer, x (32 | 256, K) bf16, K x N in "
                               "(4096, 3072), (1024, 4096), (4096, 4096), "
                               "(4096, 4096), L = 12, B=1 | B=8")
        row["shape_9b"] = ("one deer_9b decoder layer's four products, x "
                           "(32 | 256, K) bf16, K x N in (4096, 12288), "
                           "(4096, 4096), (4096, 16384), (16384, 4096), "
                           "L = 12, B=1 | B=8")
    out[0]["vl_shapes"] = [
        {"shape": r["shape"], "sk": r["sk"], "bias": r["bias"],
         "dtype": r["dtype"], "ms": r["kernel_ms"],
         "plain_ms": r["reference_ms"], "library_ms": r["library_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "max_abs_err": r["max_abs_err"]} for r in summary["k1_vl"]]
    # K1's backward: the headline is the pretraining decoder's
    # self-attention (the largest of its shapes), on its path's count
    bwd = max(summary["k1_backward"], key=lambda r: r["flops"])
    out.append({
        "name": "flash_attention_backward", "route": "cuda",
        "source": "deer_vla_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "deer_vla_tpu/ops/pallas/flash_attention.py:109",
        "replaces_note": "the gradient of K1, which the TPU kernel does not "
                         "have (no custom_vjp)",
        "launches": launches["flash_attention_backward"],
        "max_abs_err": bwd["max_abs_err"], "tolerance": bwd["tolerance"],
        "ms": bwd["kernel_ms"], "eager_ms": bwd["kernel_eager_ms"],
        "plain_ms": bwd["reference_ms"], "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"], "library_ms": bwd["library_ms"],
        "library": "torch.autograd.grad through "
                   "scaled_dot_product_attention (eager)",
        "bytes": bwd["bytes"], "flops": bwd["flops"],
        "shape": f"q {bwd['shape']} {bwd['dtype']}, Sk {bwd['sk']}, bias "
                 f"{bwd['bias']} (pretrain_3b's decoder at 256 tokens)",
        "tensor_core_sass": tc["flash_attention_backward"]["hmma_hgmma"],
        "atomics_sass": tc["flash_attention_backward"]["atomics"],
        "shapes": [{k: r[k] for k in (
            "shape", "sk", "bias", "dtype", "synthetic", "kernel_ms",
            "kernel_eager_ms", "reference_ms", "library_ms", "bound_ms",
            "bound_by", "max_abs_err", "stats_err")}
            for r in summary["k1_backward"]]})
    for row in out:
        # None where a path's counts predate the kernel (K1's backward)
        row["launches_by_path"] = {path: counts.get(row["name"])
                                   for path, counts in path_launches.items()}
    return {"kernels": out}


# ---------------------------------------------------------------------------
# the vision, state and window variants (deer_3b at full width)
# ---------------------------------------------------------------------------

# name -> DeerConfig changes ("k": head.multi_step_action; use_state sets
# the head's too, as cli/train's one flag does)
SERVE_VARIANTS = (("use_state", {"use_state": True}),
                  ("pre", {"fusion_mode": "pre"}),
                  ("two_way", {"fusion_mode": "two_way"}),
                  ("sep_resampler", {"sep_resampler": True}),
                  ("gripper_res84", {"gripper_res": 84}),
                  ("multi_step3", {"k": 3}))
FOLDED_VARIANTS = (("vit_concat", {"fusion_mode": "vit_concat"}),
                   ("use_hist", {"use_hist": True}))
CROSS_VARIANTS = (("vit_concat_use_state", {"fusion_mode": "vit_concat",
                                            "use_state": True}),
                  ("gripper_res84", {"gripper_res": 84}))
# the window-folded cross-check's ViT layers: the CPU's fp32 ViT runs its
# W=12 window of both cameras (cut from CROSS_VIT_DEPTH to pay for the
# fused_3b and pipeline phases)
FOLDED_CROSS_VIT_DEPTH = 4
# the frame cache against the uncached step: the same per-frame tokens go
# into the same fuse and decode, so the exits must be equal and the arm
# actions within 2e-4 relative L2 (both in bf16 on the card)
FOLDED_STEPS = 15
FOLDED_REL_L2 = 2e-4
VARIANT_TRAIN_DIR = REPO / "build" / "chip_smoke_variants"
VARIANT_TRAIN_ARGV = ["--debug", "--model", "mpt_dolly_3b", "--use_state",
                      "--fusion_mode", "vit_concat", "--batch_size_calvin",
                      str(TRAIN_BATCH), "--num_joint_epochs", "1",
                      "--num_exit_epochs", "0", "--joint_warmup_steps", "1",
                      "--logging_steps", "1", "--from_scratch",
                      "--run_name", str(VARIANT_TRAIN_DIR)]


def variant_config(cfg, changes: dict):
    """``cfg`` with a variant's changes."""
    changes = dict(changes)
    head = {}
    if changes.get("use_state"):
        head["use_state"] = True
    if "k" in changes:
        head["multi_step_action"] = changes.pop("k")
    return dataclasses.replace(
        cfg, head=dataclasses.replace(cfg.head, **head), **changes)


def variant_weights(torch, base: dict, cfg) -> dict:
    """The variant's tree on the base draw: its second resampler, state
    projection or frame embeddings (``init_variant_leaves``), and heads of
    its own when their widths or state embedding differ, drawn on the card
    from SEED + 2; every other leaf is the base's."""
    from deer_vla_tpu_torch.models.action_head import init_head
    from deer_vla_tpu_torch.models.flamingo import init_variant_leaves
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    pdt = cfg.dtypes.pdt
    p = dict(base)
    if cfg.head.use_state or cfg.head.multi_step_action != 1:
        for key in ("lm_head", "extra_exit"):
            p[key] = init_head(gen, cfg.head, "cuda", pdt)
        p["lm_exits"] = {k: init_head(gen, cfg.head, "cuda", pdt)
                         for k in base["lm_exits"]}
    p.update(init_variant_leaves(gen, cfg, "cuda", pdt))
    return p


def variant_inputs(np, cfg):
    """``inputs(b, seed)`` for ``phase_serve``: b streams' frames (W a
    stream, stream-major, for the window-folded variants; the gripper at
    ``gripper_res``), text (a row a frame under use_hist) and, for a state
    model, proprio rows a frame (the gripper entry at +-1)."""
    from deer_vla_tpu_torch.eval.scan_policy import folded_window
    w = folded_window(cfg)

    def inputs(b, seed):
        r = np.random.RandomState(seed)
        hw = cfg.vit.image_size
        ghw = cfg.gripper_res or hw
        img = r.randn(b * w, 1, 1, 3, hw, hw).astype(np.float32)
        grip = r.randn(b * w, 1, 1, 3, ghw, ghw).astype(np.float32)
        _, _, ids, mask = make_policy_inputs(np, cfg, b, seed)
        if cfg.use_hist:
            ids, mask = (np.repeat(a, w, axis=0) for a in (ids, mask))
        kw = {}
        if cfg.use_state:
            st = r.randn(b * w, 1, 1, cfg.state_dim).astype(np.float32)
            st[..., -1] = np.where(st[..., -1] > 0, 1.0, -1.0)
            kw["state"] = st
        return (img, grip, ids, mask), kw

    return inputs


def phase_serve_variants(torch, np, cfg, base: dict, serve: dict) -> list:
    """Each of SERVE_VARIANTS through ``ScanDeerPolicy`` with K1 and K2: 8
    B=1 and 4 B=8 steps (``phase_serve``: exits among the exit set, finite
    actions, (B, 3, 7) plans for multi_step3), medians beside the post
    model's from phase serve; use_state also in int8 (K3 must replace K2)
    and through ``DeerPolicy``, held against the scan engine with the same
    products (``phase_serve_bucketed``: equal exits)."""
    from deer_vla_tpu_torch.eval.policy import DeerPolicy
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    from deer_vla_tpu_torch.models.value_net import ExitController
    results, summary = [], {}
    for name, changes in SERVE_VARIANTS:
        vcfg = variant_config(cfg, changes)
        p = variant_weights(torch, base, vcfg)
        inputs = variant_inputs(np, vcfg)
        modes = [None] + (["int8"] if name == "use_state" else [])
        for mode in modes:
            pol = ScanDeerPolicy(p, vcfg, indexed_mm=True, quantize=mode)
            res = phase_serve(torch, np, vcfg, pol, mode,
                              name=f"serve_{name}" + (f"_{mode}" if mode
                                                      else ""),
                              inputs=inputs)
            results.append(res)
            summary[res["phase"]] = {k: res[k] for k in (
                "b1_median_ms", "b8_median_ms", "b1_exit_layers",
                "launches_per_step")}
            del pol
        if name == "use_state":
            deer = DeerPolicy(p, vcfg, controller=ExitController(
                exit_id_list=list(vcfg.all_exit_ids()),
                max_layer=vcfg.n_layers))
            scan_plain = ScanDeerPolicy(p, vcfg)
            results.append(phase_serve_bucketed(
                torch, np, vcfg, deer, scan_plain, serve,
                name="serve_use_state_bucketed", inputs=inputs))
            del deer, scan_plain
        del p
        torch.cuda.empty_cache()
    emit({"phase": "serve_variants",
          "post": {"b1_median_ms": serve["b1_median_ms"],
                   "b8_median_ms": serve["b8_median_ms"]},
          "variants": summary})
    return results


def phase_cross_check_variants(torch, np, cfg, base: dict,
                               cpu_base: dict) -> None:
    """A full-depth bf16 step of each CROSS_VARIANTS model (and the same
    weights in fp32 on the card) against fp32 on the CPU
    (``phase_cross_check``'s tolerances): vit_concat with state on a
    W-frame window (its ViT cut to FOLDED_CROSS_VIT_DEPTH layers), and the
    native-size gripper."""
    from deer_vla_tpu_torch.bridge import to_torch
    from deer_vla_tpu_torch.eval.scan_policy import (ScanDeerPolicy,
                                                     folded_window)
    for name, changes in CROSS_VARIANTS:
        vcfg = variant_config(cfg, changes)
        p = variant_weights(torch, base, vcfg)
        cpu_p = dict(cpu_base, **{k: to_torch(v, "cpu") for k, v in p.items()
                                  if v is not base.get(k)})
        if folded_window(vcfg) > 1:
            vcfg = cut_depth(vcfg, vcfg.n_layers, FOLDED_CROSS_VIT_DEPTH)
            p, cpu_p = first_layers(p, vcfg), first_layers(cpu_p, vcfg)
        pol = ScanDeerPolicy(p, vcfg, indexed_mm=True)
        phase_cross_check(torch, np, vcfg, p, cpu_p, pol,
                          name=f"cross_check_{name}",
                          inputs=variant_inputs(np, vcfg)(1, 300))
        del pol, p, cpu_p
        gc.collect()
        torch.cuda.empty_cache()


def rel_l2(np, a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def phase_serve_folded(torch, np, cfg, base: dict) -> list:
    """vit_concat and use_hist at W=12: B=1 steps over FOLDED_STEPS new
    frames, uncached (the engine re-encodes the rolling window, left padded
    with the first frame) and through ``FrameCachePolicy`` (the newest
    frame only), with equal exits and arm actions within FOLDED_REL_L2 at
    every step; K1 launches and step times of both; then 4 uncached B=8
    steps (``phase_serve``)."""
    import copy
    from deer_vla_tpu_torch.eval.caching import FrameCachePolicy
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    counters = kernel_counters()
    results = []
    for name, changes in FOLDED_VARIANTS:
        vcfg = variant_config(cfg, changes)
        w = vcfg.window_size
        p = variant_weights(torch, base, vcfg)
        pol = ScanDeerPolicy(p, vcfg, indexed_mm=True)
        cached = FrameCachePolicy(copy.copy(pol))
        (img, grip, ids, mask), _ = variant_inputs(np, vcfg)(1, 400)
        r = np.random.RandomState(401)
        hw = vcfg.vit.image_size
        frames_i = r.randn(FOLDED_STEPS, 1, 1, 3, hw, hw).astype(np.float32)
        frames_g = r.randn(FOLDED_STEPS, 1, 1, 3, hw, hw).astype(np.float32)
        runs = {}
        for kind, policy in (("uncached", pol), ("cached", cached)):
            policy.reset()
            for f in counters.values():
                f.launches = 0
            ms, exits, arms = [], [], []
            for t in range(FOLDED_STEPS):
                policy.set_thresholds([SWEEP[t % len(SWEEP)]]
                                      * len(pol.exits))
                rows = [max(0, i) for i in range(t - w + 1, t + 1)]
                fi, fg = ((frames_i[rows], frames_g[rows])
                          if kind == "uncached"
                          else (frames_i[t:t + 1], frames_g[t:t + 1]))
                t0 = time.perf_counter()
                act = policy.step(fi, fg, ids, mask)
                ms.append((time.perf_counter() - t0) * 1e3)
                check(act.shape == (7,) and bool(np.isfinite(act).all()),
                      f"serve_folded {name} {kind} step {t}: {act}")
                exits.append(policy.last_exit_layer)
                arms.append(act[:6])
            runs[kind] = {
                "step_ms": ms, "median_ms": statistics.median(ms[w:]),
                "exit_layers": exits, "arms": arms,
                "launches": {n: f.launches for n, f in counters.items()},
                "k1_per_step": counters["flash_attention"].launches
                / FOLDED_STEPS}
        u, c = runs["uncached"], runs["cached"]
        errs = [rel_l2(np, a, b) for a, b in zip(c.pop("arms"),
                                                 u.pop("arms"))]
        check(c["exit_layers"] == u["exit_layers"],
              f"serve_folded {name}: exits {c['exit_layers']} cached, "
              f"{u['exit_layers']} uncached")
        check(max(errs) <= FOLDED_REL_L2,
              f"serve_folded {name}: arm rel L2 {max(errs)}")
        check(u["launches"]["indexed_matmul"] > 0
              and c["launches"]["indexed_matmul"] > 0
              and c["k1_per_step"] > 0,
              f"serve_folded {name}: kernels not launched: {runs}")
        out = {"phase": f"serve_folded_{name}", "window": w,
               "steps": FOLDED_STEPS, "k1_images_per_step":
                   {"uncached": 2 * w, "cached": 2},
               "cached_vs_uncached_arm_rel_l2": errs,
               "tolerance": FOLDED_REL_L2, "runs": runs,
               "launches": u["launches"]}
        emit(out)
        results.append(out)
        results.append(phase_serve(
            torch, np, vcfg, pol, b1_steps=0, name=f"serve_folded_{name}_b8",
            inputs=variant_inputs(np, vcfg)))
        del pol, cached, p
        torch.cuda.empty_cache()
    return results


def phase_calibrate_variants(torch, np, cfg, base: dict) -> dict:
    """Calibration (B=2, W=12, 2 debug batches with robot_obs) of the
    use_state model in both regimes, and of vit_concat with the warm
    prefix of ``--calib_warm 2``: values finite, of the regime's shape,
    K1 launched a batch."""
    from deer_vla_tpu_torch.cli.eval import CALIB_BATCH_SIZE as bs
    from deer_vla_tpu_torch.eval.calibrate import (
        generate_calibration_values, streamed_sample_probs)
    counters = kernel_counters()
    out = {"phase": "calibrate_variants", "batch_size": bs, "runs": {}}
    for name, changes, regime, warm in (
            ("use_state", {"use_state": True}, "folded", 0),
            ("use_state", {"use_state": True}, "streamed", 0),
            ("vit_concat", {"fusion_mode": "vit_concat"}, "folded", 2)):
        vcfg, batches = calib_debug_batches(variant_config(cfg, changes),
                                            bs, 2)
        p = variant_weights(torch, base, vcfg)
        streamed = regime == "streamed"
        esp = (streamed_sample_probs(vcfg, 1.0, None, "exp", "deer_3b")
               if streamed else None)
        for f in counters.values():
            f.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v = generate_calibration_values(
            p, vcfg, batches, gen=torch.Generator(device="cuda").manual_seed(
                SEED), warm_prefix=warm, streamed=streamed,
            exit_sample_probs=esp)
        secs = time.perf_counter() - t0
        launches = {n: f.launches for n, f in counters.items()}
        folded = vcfg.fusion_mode == "vit_concat"
        per_traj = (1 if folded else vcfg.window_size // 2
                    + (1 if streamed else 0))
        check(v.shape == (vcfg.num_exits, bs * len(batches) * per_traj)
              and bool(np.isfinite(v).all()),
              f"calibrate_variants {name} {regime}: values {v.shape}")
        check(launches["flash_attention"] > 0,
              f"calibrate_variants {name}: K1 not launched: {launches}")
        out["runs"][f"{name}_{regime}"] = {
            "warm_prefix": warm, "values_shape": list(v.shape),
            "min": float(v.min()), "median": float(np.median(v)),
            "max": float(v.max()), "seconds_per_batch": secs / len(batches),
            "launches": launches}
        del p
        torch.cuda.empty_cache()
    emit(out)
    return out


def phase_train_variants(torch, np) -> list:
    """``cli/train --debug --use_state --fusion_mode vit_concat`` in-process
    at JAX's defaults (B=6, W=12), one joint epoch of 4 batches: finite
    losses, K1 24 times a step, K2-K4 never; step seconds and peak memory.
    Then ``cli/eval --evaluate_from_checkpoint --frame_cache`` on its
    checkpoint (``phase_rollout``'s checks): the sidecar config carries the
    variant into calibration and the cached scan engine."""
    import io
    from deer_vla_tpu_torch.cli import train as cli
    shutil.rmtree(VARIANT_TRAIN_DIR, ignore_errors=True)
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    held_gb = released_gb(torch)
    torch.cuda.reset_peak_memory_stats()
    steps, buf = [], io.StringIO()
    t0 = time.perf_counter()
    with train_updates(steps), contextlib.redirect_stdout(buf):
        trainer = cli.main(VARIANT_TRAIN_ARGV)
    seconds = time.perf_counter() - t0
    launches = {n: f.launches for n, f in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "cli_train_variants.log").write_text(buf.getvalue())
    cfg = trainer.cfg
    check(cfg.fusion_mode == "vit_concat" and cfg.use_state
          and cfg.head.use_state, f"train_variants: config {cfg}")
    check(len(steps) == TRAIN_STEPS // 2 and all(
        np.isfinite(s["loss"]) for s in steps),
        f"train_variants: losses {[s['loss'] for s in steps]}")
    check(launches["flash_attention"] == VIT_LAYERS * len(steps)
          and all(launches[n] == 0 for n in DECODER_KERNEL.values()),
          f"train_variants: launches {launches}")
    secs = step_intervals(steps)
    out = {"phase": "train_variants", "argv": VARIANT_TRAIN_ARGV,
           "seconds": seconds, "losses": [s["loss"] for s in steps],
           "step_s": secs, "step_s_median": statistics.median(secs),
           "peak_memory_gb": peak_gb, "allocated_before_gb": held_gb,
           "trainable": len(steps[0]["keys"]), "launches": launches}
    emit(out)
    del trainer
    released_gb(torch)
    argv = ["--debug", "--model", "deer_3b", "--evaluate_from_checkpoint",
            str(VARIANT_TRAIN_DIR / "deer_0.ckpt"), "--calib_batches", "2",
            "--num_sequences_override", "2", "--ep_len", "40",
            "--exit_ratio", "0.5", "--frame_cache", "--calib_warm", "2"]
    out["runs"] = {"eval_frame_cache": phase_rollout(
        torch, np, "train_variants_eval", argv)}
    shutil.rmtree(VARIANT_TRAIN_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return [out]


# ---------------------------------------------------------------------------
# the head families (ROADMAP M10b: fc, gpt, diffusion) on the deer_3b draw
# ---------------------------------------------------------------------------

# name -> DeerConfig changes: the fc head needs the window folded, the
# diffusion head takes the default 150 timesteps, horizon 32, 6 steps of
# history and down dims (256, 512, 1024)
HEAD_FAMILIES = (("gpt", {"head_type": "gpt"}),
                 ("fc", {"head_type": "fc", "fusion_mode": "vit_concat"}),
                 ("diffusion", {"head_type": "diffusion"}))
# the thresholds the head phases sweep, one a step (a stream at B=8): six
# decades, as the families compare arm actions or 1024-wide features
HEAD_SWEEP = [10.0 ** (-6 + 6 * s / 7) for s in range(8)]
# DDIM evaluations of a plan in the serve and rollout phases
DDIM_STEPS = 10
# the U-Net on the card against fp32 on the CPU with the same inputs and
# noise: the convolutions are fp32 products (no TF32; the settings are
# recorded beside), so one call differs by summation order (1e-5 relative
# L2), and a DDIM plan, 10 calls deep and scaled by 1 / sqrt(alpha_bar) at
# the chain's start, is held to 1e-4
UNET_TOL = {"unet_rel_l2": 1e-5, "plan_rel_l2": 1e-4}
HEAD_TRAIN_DIR = REPO / "build" / "chip_smoke_heads"
# the head families train deer_3b's widths at 4 of its 12 decoder layers
# (exits 1 and 3): at 12 the gpt run's 7 heads of 403M fp32 parameters made
# a 41.6 GB checkpoint and took 49.6 s on an H100 host
HEAD_TRAIN_DEPTH = ["--max_layer", "4"]
HEAD_TRAIN_ARGV = ["--debug", "--model", "mpt_dolly_3b", "--batch_size_calvin",
                   str(TRAIN_BATCH), "--num_joint_epochs", "1",
                   "--num_exit_epochs", "0", "--joint_warmup_steps", "1",
                   "--logging_steps", "1", "--from_scratch"] + HEAD_TRAIN_DEPTH
HEAD_ROLLOUTS = (
    ("rollout_gpt", ["--head_type", "gpt"]),
    ("rollout_diffusion", ["--head_type", "diffusion", "--diff_steps",
                           str(DDIM_STEPS)]),
    ("rollout_diffusion_lanes2", ["--head_type", "diffusion", "--diff_steps",
                                  str(DDIM_STEPS), "--lanes", "2"]))


def head_weights(torch, np, base: dict, cfg) -> dict:
    """The family's tree on the base draw: every head (final, per-layer
    exits, extra exit) of ``cfg.head_type`` drawn on the card from
    SEED + 3, then the variant leaves and, for diffusion, the U-Net and the
    normalizer, fitted on 2 debug batches' actions; the backbone is the
    base's."""
    from deer_vla_tpu_torch.models.flamingo import (init_diffusion_leaves,
                                                    init_variant_leaves)
    from deer_vla_tpu_torch.models.heads import init_any_head
    from deer_vla_tpu_torch.train.trainer import fit_action_normalizer
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    pdt = cfg.dtypes.pdt
    p = dict(base)
    for key in ("lm_head", "extra_exit"):
        p[key] = init_any_head(gen, cfg, "cuda", pdt)
    p["lm_exits"] = {k: init_any_head(gen, cfg, "cuda", pdt)
                     for k in base["lm_exits"]}
    p.update(init_variant_leaves(gen, cfg, "cuda", pdt))
    if cfg.head_type == "diffusion":
        p.update(init_diffusion_leaves(gen, cfg, "cuda", pdt))
        p = fit_action_normalizer(p, calib_debug_batches(cfg, 2, 2)[1])
    return p


def unet_settings(torch) -> dict:
    return {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def plan_inputs(torch, np, sampler, b: int, seed: int, device):
    """(cond, mask, features, noise) of ``b`` plans with a random history,
    drawn on the host and moved to ``device``."""
    r = np.random.RandomState(seed)
    hist = r.uniform(-1, 1, (b, sampler.hist_len, sampler.adim)).astype(
        np.float32)
    cond, mask = sampler.cond(hist)
    feats = torch.as_tensor(r.randn(b, sampler.dcfg.global_cond_dim).astype(
        np.float32))
    noise = sampler.noise(SEED, range(b)).cpu()
    return (cond.to(device), mask.to(device), feats.to(device),
            noise.to(device))


def profiled_launches(torch, fn) -> dict:
    """CUDA kernels launched by one ``fn()`` and their busy time
    (torch.profiler, the device's activity only: the host's op events, a
    few for each of a long plan's launches, cost more to collect than the
    plan), beside its host-clock time."""
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total", None)
               or getattr(e, "self_cuda_time_total", 0.0)
               for e in kernels) / 1e3
    return {"kernel_launches": sum(e.count for e in kernels),
            "device_busy_ms": busy, "profiled_wall_ms": wall}


def phase_diffusion_plans(torch, np, cfg, p, pol) -> dict:
    """The diffusion model's plans on the card: the feature step (the scan
    engine, K1 and K2, median of 5) and the plan apart.  A DDIM plan of
    DDIM_STEPS U-Net evaluations is timed on the host clock (median of 5
    after one), profiled once for its CUDA launches, and runs 4 steps of
    ``DiffusionSamplerPolicy`` around the engine; the full 150-evaluation
    DDPM chain (``models/diffusion.conditional_sample``) runs once through
    the wrapper (its step less the feature step's median is its plan
    time), unprofiled for the script's time limit (the profile of its
    123,000 launches took most of 20 s).  Each wrapper step gives a finite
    (W - hist, 7) plan with the gripper at +-1."""
    from deer_vla_tpu_torch.eval.diffusion_policy import \
        DiffusionSamplerPolicy
    from deer_vla_tpu_torch.models.diffusion import sampler_steps
    pol.set_thresholds([HEAD_SWEEP[4]] * len(pol.exits))
    pol.reset()
    args, _ = variant_inputs(np, cfg)(1, 500)
    feat_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        feature = pol.step(*args)
        feat_ms.append((time.perf_counter() - t0) * 1e3)
    feat_median = statistics.median(feat_ms)
    out = {"phase": "serve_heads_diffusion_plans",
           "feature_step_ms": feat_ms, "feature_step_median_ms": feat_median,
           "feature_width": int(feature.shape[0]),
           "unet_settings": unet_settings(torch), "plans": {}}
    rows = cfg.window_size - (cfg.n_obs_steps - 1)
    for kind, steps, wrapper_steps in (("ddim", DDIM_STEPS, 4),
                                       ("ddpm", 0, 1)):
        wrapper = DiffusionSamplerPolicy(pol, p, seed=SEED,
                                         sample_steps=steps)
        s = wrapper.sampler
        cond, mask, feats, noise = plan_inputs(torch, np, s, 1, 501, "cuda")

        def plan():
            return s.sample(cond, mask, feats, noise)

        ms = []
        if kind == "ddim":
            plan()
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                x = plan()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            check(bool(torch.isfinite(x).all()), "ddim plan not finite")
        wrapper.reset()
        plans, step_ms = [], []
        for t in range(wrapper_steps):
            t0 = time.perf_counter()
            plans.append(wrapper.step(*variant_inputs(np, cfg)(1, 510 + t)[0]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        check(all(a.shape == (rows, 7) and bool(np.isfinite(a).all())
                  and set(a[:, 6].tolist()) <= {-1.0, 1.0} for a in plans),
              f"{kind}: sampler plans {[a.shape for a in plans]}")
        evals = sampler_steps(s.dcfg, steps)
        record = {"unet_evaluations": evals, "sampler_step_ms": step_ms,
                  "sampler_plan_rows": rows}
        if kind == "ddpm":
            ms = [step_ms[0] - feat_median]
        else:
            prof = profiled_launches(torch, plan)
            record.update(
                launches_per_plan=prof["kernel_launches"],
                launches_per_unet=prof["kernel_launches"] / evals,
                device_busy_ms=prof["device_busy_ms"],
                profiled_wall_ms=prof["profiled_wall_ms"])
        out["plans"][kind] = dict(record, plan_ms=ms,
                                  plan_median_ms=statistics.median(ms))
    emit(out)
    return out


def full_depth_launches(torch, np, cfg, pol) -> dict:
    """Every CUDA kernel a full-depth step launches (every exit checked,
    the last one taken) and the device's busy time, at B=1 and B=8, one
    profiled step each after one unprofiled."""
    out = {}
    pol.set_thresholds([-1.0] * (len(pol.exits) - 1) + [1e8])
    for b in (1, 8):
        args, _ = variant_inputs(np, cfg)(b, 600 + b)

        def step():
            pol.reset()
            return pol.step_batch(*args) if b > 1 else pol.step(*args)

        step()
        out[f"b{b}"] = profiled_launches(torch, step)
    return out


def phase_serve_heads(torch, np, cfg, base: dict, serve: dict) -> list:
    """Each HEAD_FAMILIES model through ``ScanDeerPolicy`` with K1 and K2:
    8 B=1 and 4 B=8 steps over HEAD_SWEEP (``phase_serve``: exits among
    the exit set, finite outputs: a 7-dof action, or the diffusion head's
    1024-wide feature), peak memory, and every CUDA launch of a full-depth
    step at B=1 and B=8 beside post's (``full_depth_launches``); the gpt
    model also through
    ``DeerPolicy``, held against the scan engine with the same products
    (``phase_serve_bucketed``: equal exits, actions within 1e-2); the
    diffusion model's plans (``phase_diffusion_plans``)."""
    from deer_vla_tpu_torch.eval.policy import DeerPolicy
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    from deer_vla_tpu_torch.models.value_net import ExitController
    from deer_vla_tpu_torch.train.optimizer import flat_leaves
    results, summary = [], {}
    pol = ScanDeerPolicy(base, cfg, indexed_mm=True)
    summary["post"] = full_depth_launches(torch, np, cfg, pol)
    del pol
    for name, changes in HEAD_FAMILIES:
        hcfg = variant_config(cfg, changes)
        p = head_weights(torch, np, base, hcfg)
        pol = ScanDeerPolicy(p, hcfg, indexed_mm=True)
        torch.cuda.reset_peak_memory_stats()
        res = phase_serve(torch, np, hcfg, pol, name=f"serve_heads_{name}",
                          sweep=HEAD_SWEEP, inputs=variant_inputs(np, hcfg))
        res["head_params"] = sum(
            v.numel() for v in flat_leaves(p["extra_exit"]).values())
        res["full_depth"] = full_depth_launches(torch, np, hcfg, pol)
        results.append(res)
        summary[name] = {k: res[k] for k in (
            "b1_median_ms", "b8_median_ms", "b1_exit_layers",
            "launches_per_step", "peak_mem_gb", "head_params", "full_depth")}
        if name == "gpt":
            deer = DeerPolicy(p, hcfg, controller=ExitController(
                exit_id_list=list(hcfg.all_exit_ids()),
                max_layer=hcfg.n_layers))
            scan_plain = ScanDeerPolicy(p, hcfg)
            results.append(phase_serve_bucketed(
                torch, np, hcfg, deer, scan_plain, serve,
                name="serve_heads_gpt_bucketed", sweep=HEAD_SWEEP,
                inputs=variant_inputs(np, hcfg)))
            del deer, scan_plain
        if name == "diffusion":
            plans = phase_diffusion_plans(torch, np, hcfg, p, pol)
            results.append(plans)
            summary[name]["plans"] = {k: {x: v[x] for x in (
                "plan_median_ms", "launches_per_plan", "unet_evaluations")
                if x in v} for k, v in plans["plans"].items()}
        del pol, p
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "serve_heads",
          "post": {"b1_median_ms": serve["b1_median_ms"],
                   "b8_median_ms": serve["b8_median_ms"]},
          "families": summary})
    return results


def phase_cross_check_heads(torch, np, cfg, base: dict,
                            cpu_base: dict) -> None:
    """A full-depth bf16 step of the gpt and the fc model (and the same
    weights in fp32 on the card) against fp32 on the CPU
    (``phase_cross_check``'s tolerances); then the diffusion model's U-Net
    (3 rows at timesteps 0, 75, 149) and a DDIM plan of DDIM_STEPS
    evaluations, on the card against the CPU with the same inputs and
    noise (UNET_TOL)."""
    from deer_vla_tpu_torch.bridge import to_torch
    from deer_vla_tpu_torch.eval.diffusion_policy import _PlanSampler
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    from deer_vla_tpu_torch.models.diffusion import unet_forward
    for name, changes in HEAD_FAMILIES[:2]:
        hcfg = variant_config(cfg, changes)
        p = head_weights(torch, np, base, hcfg)
        cpu_p = dict(cpu_base, **{k: to_torch(v, "cpu") for k, v in p.items()
                                  if v is not base.get(k)})
        pol = ScanDeerPolicy(p, hcfg, indexed_mm=True)
        phase_cross_check(torch, np, hcfg, p, cpu_p, pol,
                          name=f"cross_check_heads_{name}",
                          inputs=variant_inputs(np, hcfg)(1, 300))
        del pol, p, cpu_p
        gc.collect()
        torch.cuda.empty_cache()
    hcfg = variant_config(cfg, dict(HEAD_FAMILIES)["diffusion"])
    p = head_weights(torch, np, base, hcfg)
    card = _PlanSampler(hcfg, p, "cuda", DDIM_STEPS, 0.0)
    cpu = _PlanSampler(hcfg, p, "cpu", DDIM_STEPS, 0.0)
    cond, mask, feats, noise = plan_inputs(torch, np, cpu, 3, 520, "cpu")
    t = torch.tensor([0, 75, 149])
    x = noise[0]
    with torch.inference_mode():
        u_card = unet_forward(card.unet, x.cuda(), t.cuda(), card.dcfg,
                              feats.cuda()).cpu()
        u_cpu = unet_forward(cpu.unet, x, t, cpu.dcfg, feats)
        x_card = card.sample(cond.cuda(), mask.cuda(), feats.cuda(),
                             noise.cuda()).cpu()
        x_cpu = cpu.sample(cond, mask, feats, noise)
    got = {"unet_rel_l2": rel_l2(np, u_card.numpy(), u_cpu.numpy()),
           "plan_rel_l2": rel_l2(np, x_card.numpy(), x_cpu.numpy()),
           "plan_max_abs": float((x_card - x_cpu).abs().max())}
    emit({"phase": "cross_check_heads_diffusion", "ddim_steps": DDIM_STEPS,
          "unet_rows": 3, "timesteps": t.tolist(), "card_vs_cpu_fp32": got,
          "tolerance": UNET_TOL, "unet_settings": unet_settings(torch)})
    for key, limit in UNET_TOL.items():
        check(got[key] <= limit, f"cross_check_heads_diffusion {key} "
                                 f"{got[key]}")
    del card, cpu, p
    torch.cuda.empty_cache()


def realized_mix(np, values, thresholds: dict, exits: list) -> list:
    """The exit mix the thresholds give the calibration samples: a sample
    exits at the first exit whose delta is at most its threshold, at the
    last one otherwise."""
    taken = np.full(values.shape[1], len(exits) - 1)
    for i in reversed(range(len(exits) - 1)):
        taken = np.where(values[i] <= thresholds[exits[i]], i, taken)
    return (np.bincount(taken, minlength=len(exits))
            / values.shape[1]).tolist()


def phase_calibrate_heads(torch, np, cfg, base: dict) -> dict:
    """Calibration (B=2, W=12, 2 debug batches) of the gpt and the
    diffusion model, folded and streamed: seconds and kernel counts a
    batch, the deltas (the diffusion head's on its features), and the
    realized mix on the samples of the thresholds solved for ratio 0.5
    against its target."""
    from deer_vla_tpu_torch.cli.eval import CALIB_BATCH_SIZE as bs
    from deer_vla_tpu_torch.eval.calibrate import (
        generate_calibration_values, streamed_sample_probs)
    from deer_vla_tpu_torch.models.value_net import (exit_probs,
                                                     solve_thresholds)
    counters = kernel_counters()
    out = {"phase": "calibrate_heads", "batch_size": bs, "runs": {}}
    for name in ("gpt", "diffusion"):
        hcfg, batches = calib_debug_batches(
            variant_config(cfg, dict(HEAD_FAMILIES)[name]), bs, 2)
        p = head_weights(torch, np, base, hcfg)
        exits = list(hcfg.all_exit_ids())
        for regime in ("folded", "streamed"):
            streamed = regime == "streamed"
            esp = (streamed_sample_probs(hcfg, 0.5, None, "exp", "deer_3b")
                   if streamed else None)
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            vals, secs, launches = [], [], []
            for batch in batches:
                for f in counters.values():
                    f.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                vals.append(generate_calibration_values(
                    p, hcfg, [batch], gen=gen, streamed=streamed,
                    exit_sample_probs=esp))
                secs.append(time.perf_counter() - t0)
                launches.append({n: f.launches for n, f in counters.items()})
            v = np.concatenate(vals, axis=1)
            per_traj = hcfg.window_size // 2 + (1 if streamed else 0)
            check(v.shape == (len(exits), bs * len(batches) * per_traj)
                  and bool(np.isfinite(v).all()),
                  f"calibrate_heads {name} {regime}: values {v.shape}")
            check(all(n["flash_attention"] > 0 for n in launches),
                  f"calibrate_heads {name}: K1 not launched: {launches}")
            th, _ = solve_thresholds(v, 0.5, exits, hcfg.n_layers - 1,
                                     model_name="deer_3b")
            target = exit_probs(len(exits), 0.5, "exp", "deer_3b").tolist()
            mix = realized_mix(np, v, th, exits)
            out["runs"][f"{name}_{regime}"] = {
                "values_shape": list(v.shape), "min": float(v.min()),
                "median": float(np.median(v)), "max": float(v.max()),
                "thresholds": th, "target_mix": target,
                "realized_mix": mix,
                "mix_max_abs_gap": max(abs(a - b)
                                       for a, b in zip(mix, target)),
                "seconds_per_batch": secs, "launches": launches[-1]}
        del p
        torch.cuda.empty_cache()
    emit(out)
    return out


def phase_train_heads(torch, np) -> list:
    """``cli/train --debug --head_type diffusion`` and ``--head_type gpt``
    in-process at JAX's defaults (B=6, W=12), one joint epoch of 4
    batches: finite losses, K1 24 times a step and K2-K4 never, step
    seconds and peak memory; the diffusion run's checkpoint holds the
    normalizer it fitted.  Then ``cli/eval --evaluate_from_checkpoint`` on
    each checkpoint (``phase_rollout``'s checks; DDIM for diffusion).  The
    run directories are deleted after."""
    import io
    from deer_vla_tpu_torch.cli import train as cli
    from deer_vla_tpu_torch.train.checkpoint import load_checkpoint
    from deer_vla_tpu_torch.train.optimizer import flat_leaves
    results = []
    for name, flags, eval_flags in (
            ("diffusion", ["--head_type", "diffusion"],
             ["--diff_steps", str(DDIM_STEPS)]),
            ("gpt", ["--head_type", "gpt"], [])):
        run = HEAD_TRAIN_DIR / name
        shutil.rmtree(run, ignore_errors=True)
        argv = HEAD_TRAIN_ARGV + ["--run_name", str(run)] + flags
        counters = kernel_counters()
        for f in counters.values():
            f.launches = 0
        held_gb = released_gb(torch)
        torch.cuda.reset_peak_memory_stats()
        steps, buf = [], io.StringIO()
        t0 = time.perf_counter()
        with train_updates(steps), contextlib.redirect_stdout(buf):
            trainer = cli.main(argv)
        seconds = time.perf_counter() - t0
        launches = {n: f.launches for n, f in counters.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        (OUT_DIR / f"cli_train_heads_{name}.log").write_text(buf.getvalue())
        check(trainer.cfg.head_type == name, f"train_heads {name}: config")
        check(len(steps) == TRAIN_STEPS // 2 and all(
            np.isfinite(s["loss"]) for s in steps),
            f"train_heads {name}: losses {[s['loss'] for s in steps]}")
        check(launches["flash_attention"] == VIT_LAYERS * len(steps)
              and all(launches[n] == 0 for n in DECODER_KERNEL.values()),
              f"train_heads {name}: launches {launches}")
        ckpt = run / "deer_0.ckpt"
        out = {"phase": f"train_heads_{name}", "argv": argv,
               "seconds": seconds, "losses": [s["loss"] for s in steps],
               "step_s": step_intervals(steps),
               "step_s_median": statistics.median(step_intervals(steps)),
               "peak_memory_gb": peak_gb, "allocated_before_gb": held_gb,
               "trainable": len(steps[0]["keys"]),
               "trainable_params": sum(
                   v.numel() for k, v in flat_leaves(trainer.params).items()
                   if k in steps[0]["keys"]),
               "checkpoint_bytes": ckpt.stat().st_size, "launches": launches}
        if name == "diffusion":
            norm = trainer.params["diffusion"]["norm"]
            saved = load_checkpoint(str(ckpt), trainer.params)[0][
                "diffusion"]["norm"]
            check(all(torch.equal(saved[k], norm[k]) for k in norm)
                  and not bool((norm["scale"] == 1).all()),
                  "train_heads diffusion: the fitted normalizer is not in "
                  "the checkpoint")
            out["normalizer"] = {k: v.tolist() for k, v in norm.items()}
        emit(out)
        del trainer
        released_gb(torch)
        eval_argv = (["--debug", "--model", "deer_3b",
                      "--evaluate_from_checkpoint", str(ckpt)]
                     + ROLLOUT_ARGV[3:] + HEAD_TRAIN_DEPTH + eval_flags)
        out["runs"] = {"eval": phase_rollout(
            torch, np, f"train_heads_{name}_eval", eval_argv)}
        shutil.rmtree(run, ignore_errors=True)
        torch.cuda.empty_cache()
        results.append(out)
    shutil.rmtree(HEAD_TRAIN_DIR, ignore_errors=True)
    return results


# ---------------------------------------------------------------------------
# deployment: the HTTP servers, cli/serve and the download-free rollout
# options (ROADMAP M14, M9b), deer_3b at full width
# ---------------------------------------------------------------------------

# serve_http: client threads, a stream each, steps a stream
HTTP_STREAMS = 4
HTTP_STEPS = 6
# serve_http_batched: lanes, live streams (the other lanes parked), window
BATCH_LANES = 8
BATCH_STREAMS = 6
BATCH_WINDOW_MS = 5.0
# serve_http_variants: diffusion streams x steps (DDIM_STEPS evaluations a
# plan), then vit_concat + use_state streams x steps on BATCH_LANES lanes
DIFF_HTTP = (2, 3)
FOLDED_HTTP = (4, 3)
# CALVIN's camera frames: 200 px static, 84 px gripper
CALVIN_HW = {"rgb": 200, "gripper": 84}
HTTP_INSTRUCTIONS = ("push the red block left", "lift the blue block",
                     "open the drawer", "turn on the led",
                     "move the slider right", "rotate the pink block")
SERVE_CLI_DIR = TRAIN_DIR  # the training phase's checkpoint and sidecar
# the trainer's tcp-frame labels on the card against the CPU: the same fp32
# trigonometry in other implementations; the orientation is scaled by 100,
# so a few fp32 ulps of an angle are about 1e-5 there
TCP_LABEL_TOL = 1e-4


def http_payload(np, stream: str, seed: int, instruction: str,
                 robot_obs=None) -> dict:
    """A /v1/step body with random CALVIN-size uint8 frames (base64)."""
    import base64
    r = np.random.RandomState(seed)
    out = {"stream": stream, "instruction": instruction}
    for key, hw in CALVIN_HW.items():
        f = r.randint(0, 256, (hw, hw, 3), dtype=np.uint8)
        out[key] = base64.b64encode(f.tobytes()).decode()
        out[key + "_shape"] = [hw, hw, 3]
    if robot_obs is not None:
        out["robot_obs"] = [float(x) for x in robot_obs]
    return out


def frames_of(np, payload: dict) -> tuple:
    """The (rgb, gripper) uint8 frames of a /v1/step body."""
    import base64
    return tuple(np.frombuffer(base64.b64decode(payload[k]), np.uint8)
                 .reshape(payload[k + "_shape"]).copy()
                 for k in ("rgb", "gripper"))


def http_post(base: str, path: str, payload, expect: int = 200) -> dict:
    import urllib.error
    import urllib.request
    body = (payload if isinstance(payload, bytes)
            else json.dumps(payload).encode())
    req = urllib.request.Request(base + path, data=body, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            code, out = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        code, out = e.code, json.loads(e.read())
    check(code == expect, f"{path}: HTTP {code}, {expect} expected: {out}")
    return out


def http_get(base: str, path: str) -> dict:
    import urllib.request
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return json.loads(r.read())


@contextlib.contextmanager
def serving(core):
    """``make_server`` on 127.0.0.1, a free port, served from a thread;
    yields the base URL and stops the server after."""
    import threading
    from deer_vla_tpu_torch.serving.server import make_server
    httpd = make_server(core, host="127.0.0.1", port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        if hasattr(core, "shutdown"):
            core.shutdown()


def in_threads(fns: list) -> list:
    """Runs each ``fn()`` in its own thread, all at once; their results,
    or the first exception raised."""
    import threading
    results, errors = [None] * len(fns), []

    def run(i):
        try:
            results[i] = fns[i]()
        except BaseException as e:  # reported in the phase's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors:
        raise errors[0]
    return results


def threshold_profiles(calib: dict, exits: list) -> dict:
    """The per-stream rows the serve phases override with /v1/reset: the
    first exit, the last exit, and the calibrated row (phase calibrate's
    folded thresholds at exit ratio 0.5)."""
    th = calib["regimes"]["folded"]["thresholds"]["0.5"]
    return {"first": [1e30] * len(exits),
            "last": [-1e30] * (len(exits) - 1) + [1e30],
            "calibrated": [float(th[e]) for e in exits]}


def serving_tokenizer(cfg):
    """The debug tokenizer and ``cfg`` with its media token, as cli/serve
    builds them."""
    from deer_vla_tpu_torch.data.text import HashTokenizer
    tok = HashTokenizer(vocab_size=cfg.mpt.vocab_size, max_length=cfg.text_len)
    return tok, dataclasses.replace(cfg, media_token_id=tok.media_token_id)


def check_decoder_launches(phase: str, launches: dict, quantize) -> None:
    """K1 and the mode's decoder kernel launched, the other decoder kernels
    not."""
    decoder = DECODER_KERNEL[quantize]
    others = set(DECODER_KERNEL.values()) - {decoder}
    check(launches["flash_attention"] > 0 and launches[decoder] > 0
          and all(launches[k] == 0 for k in others),
          f"{phase}: K1 and {decoder} alone must launch: {launches}")


def phase_serve_http(torch, np, cfg, profiles: dict, pol, tok,
                     quantize=None) -> dict:
    """``DeerActionServer`` around ``pol`` behind ``make_server``: one
    client thread a stream (HTTP_STREAMS), each resetting its stream with
    a threshold profile and stepping HTTP_STEPS CALVIN-size frame pairs,
    with the kernel counts set to 0 before and read after; then each
    stream's requests again through a local ``CalvinPolicyAdapter`` on its
    own view of the engine: actions and exit layers bit-equal.  Also
    healthz and a malformed request (400)."""
    from deer_vla_tpu_torch.eval.rollout import CalvinPolicyAdapter
    from deer_vla_tpu_torch.serving.server import (DeerActionServer,
                                                   engine_mode)
    name = "serve_http" + (f"_{quantize}" if quantize else "")
    names = [f"arm{i}" for i in range(HTTP_STREAMS)]
    kinds = list(profiles)
    prof = {n: kinds[i % len(kinds)] for i, n in enumerate(names)}
    reqs = {n: [http_payload(np, n, 5000 + 100 * i + t,
                             HTTP_INSTRUCTIONS[i])
                for t in range(HTTP_STEPS)] for i, n in enumerate(names)}
    core = DeerActionServer(pol, tok, max_streams=2 * HTTP_STREAMS)
    counters = kernel_counters()
    with serving(core) as base:
        def client(n):
            http_post(base, "/v1/reset", {"stream": n,
                                          "thresholds": profiles[prof[n]]})
            return [http_post(base, "/v1/step", p) for p in reqs[n]]

        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        served = dict(zip(names, in_threads([lambda n=n: client(n)
                                             for n in names])))
        wall = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters.items()}
        health = http_get(base, "/healthz")
        bad = dict(reqs[names[0]][0], rgb_shape=[199, 200, 3])
        err = http_post(base, "/v1/step", bad, expect=400)
    check_decoder_launches(name, launches, quantize)
    check(health["steps"] == HTTP_STREAMS * HTTP_STEPS
          and health["streams"] == sorted(names)
          and health["quantize"] == quantize,
          f"{name}: healthz {health}")
    mismatches, exits = [], {}
    for n in names:
        local = CalvinPolicyAdapter(DeerActionServer._clone_policy(pol), tok,
                                    text_len=cfg.text_len)
        with engine_mode(pol.device):
            local.policy.set_thresholds(profiles[prof[n]])
            for t, (p, out) in enumerate(zip(reqs[n], served[n])):
                rgb, grip = frames_of(np, p)
                local.policy.set_timestep(t)
                want = local.step({"rgb_obs": {"rgb_static": rgb,
                                               "rgb_gripper": grip}},
                                  p["instruction"])
                if (out["action"] != want.tolist()
                        or out["exit_layer"] != local.current_exit_layer):
                    mismatches.append((n, t, out["exit_layer"],
                                       local.current_exit_layer))
        exits[n] = [o["exit_layer"] for o in served[n]]
    check(not mismatches, f"{name}: served steps differ from the local "
                          f"adapter's: {mismatches}")
    every = {e for row in exits.values() for e in row}
    check(len(every) > 1, f"{name}: every stream exits at {every}")
    step_ms = [o["step_ms"] for n in names for o in served[n]]
    out = {"phase": name, "config": "deer_3b", "quantize": quantize,
           "streams": HTTP_STREAMS, "steps_per_stream": HTTP_STEPS,
           "frames": CALVIN_HW, "profiles": prof, "exit_layers": exits,
           "bit_equal_to_local_adapter": True,
           "step_ms": step_ms, "step_median_ms": statistics.median(step_ms),
           "wall_s": wall,
           "actions_per_s": HTTP_STREAMS * HTTP_STEPS / wall,
           "bad_request": err["error"], "launches": launches,
           "launches_per_step": {k: v / (HTTP_STREAMS * HTTP_STEPS)
                                 for k, v in launches.items()}}
    emit(out)
    return out


def prep_frame(torch, frame, size: int, device):
    """A uint8 (H, W, 3) camera frame as the ViT takes it, straight from
    ``clip_preprocess``."""
    from deer_vla_tpu_torch.data.preprocess import clip_preprocess
    return clip_preprocess(torch.as_tensor(frame, device=device)[None],
                           size)[0]


def lane_batch(torch, np, cfg, tok, engine, lanes: int, lanes_in: dict
               ) -> tuple:
    """A reference dispatch of ``engine`` at ``lanes`` lanes, built from the
    public pieces alone (``clip_preprocess``, the tokenizer with
    ``fixed_length``, ``threshold_row``) and none of the core's own:
    ``lanes_in`` maps a lane to (frame window [(rgb, grip) uint8],
    instruction, state window or None, threshold list); every other lane is
    parked on zero frames and a row that exits at the first exit.  Returns
    the step_batch arguments and the threshold rows."""
    from deer_vla_tpu_torch.data.text import fixed_length
    from deer_vla_tpu_torch.eval.scan_policy import folded_window
    check(not cfg.use_hist, "lane_batch builds one text row a lane")
    window = folded_window(cfg)
    size = cfg.vit.image_size
    sizes = (size, cfg.gripper_res or size)
    s = cfg.text_len
    imgs, grips, states = [], [], []
    ids = np.zeros((lanes, s), np.int64)
    masks = np.zeros((lanes, s), np.int64)
    park = engine.threshold_row([1e30] + [-1e30] * (len(engine.exits) - 1))
    rows = np.tile(park, (lanes, 1))
    zero_state = np.zeros(cfg.state_dim, np.float32)
    zero = [prep_frame(torch, np.zeros((hw, hw, 3), np.uint8), hw,
                       engine.device) for hw in sizes]
    for lane in range(lanes):
        if lane not in lanes_in:
            imgs += [zero[0]] * window
            grips += [zero[1]] * window
            states += [zero_state] * window
            continue
        frames, instruction, st, row = lanes_in[lane]
        imgs += [prep_frame(torch, f[0], sizes[0], engine.device)
                 for f in frames]
        grips += [prep_frame(torch, f[1], sizes[1], engine.device)
                  for f in frames]
        states += st if st is not None else [zero_state] * window
        i, m = tok([instruction])
        i, m = fixed_length(i, m, s, getattr(tok, "pad_token_id", 0))
        ids[lane], masks[lane] = np.asarray(i[0]), np.asarray(m[0])
        rows[lane] = engine.threshold_row(row)
    state = (np.stack(states)[:, None, None, :]
             if cfg.use_state or cfg.head.use_state else None)
    return ((torch.stack(imgs)[:, None, None],
             torch.stack(grips)[:, None, None], ids, masks, state), rows)


def replay_lanes(torch, np, cfg, tok, engine, lanes: int, lane_of: dict,
                 reqs: dict, rows: dict, served: dict, steps: int) -> list:
    """Each step t of the served streams again through ``step_batch`` of a
    copy of ``engine`` (its own carry), every stream at its lane with its
    threshold list, the other lanes parked (``lane_batch``); window-folded,
    a stream's rolling window is left-padded with its first frame.
    Returns the (stream, step) pairs whose action or exit layer is not
    bit-equal to the served one."""
    import copy
    from deer_vla_tpu_torch.eval.scan_policy import folded_window
    from deer_vla_tpu_torch.serving.server import engine_mode
    ref = copy.copy(engine)
    ref.reset()
    w = folded_window(cfg)
    use_state = cfg.use_state or cfg.head.use_state
    bad = []
    with engine_mode(engine.device):
        for t in range(steps):
            lanes_in = {}
            for n, ps in reqs.items():
                idx = [max(0, i) for i in range(t - w + 1, t + 1)]
                st = None
                if use_state:
                    st = [np.asarray(ps[i]["robot_obs"], np.float32)
                          for i in idx]
                lanes_in[lane_of[n]] = ([frames_of(np, ps[i]) for i in idx],
                                        ps[t]["instruction"], st, rows[n])
            args, trows = lane_batch(torch, np, cfg, tok, engine, lanes,
                                     lanes_in)
            ref.set_threshold_array(trows)
            acts, exits = ref.step_batch(*args)
            for n in reqs:
                lane, out = lane_of[n], served[n][t]
                if (out["action"] != np.asarray(acts[lane]).tolist()
                        or out["exit_layer"] != int(exits[lane])):
                    bad.append((n, t, out["exit_layer"], int(exits[lane])))
    return bad


def batched_run(torch, np, core, engine, tok, name: str, reqs: dict,
                rows: dict, parked: list, steps: int, quantize=None) -> dict:
    """Every stream of ``reqs`` stepped over HTTP from its own thread
    through the micro-batching ``core`` around ``engine`` (``parked``
    streams hold lanes and never step), the kernel counts set to 0 before
    and read after; the parked lanes' carry rows must come back bit for bit
    and each stream must equal its replay (``replay_lanes``).  A new stream
    takes the lowest free lane, so the resets' order gives the lanes."""
    from deer_vla_tpu_torch.eval.scan_policy import folded_window
    counters = kernel_counters()
    lane_of = {n: i for i, n in enumerate(list(parked) + list(reqs))}
    with serving(core) as base:
        for n in parked:
            http_post(base, "/v1/reset", {"stream": n})
        for n in reqs:
            http_post(base, "/v1/reset", {"stream": n, "thresholds":
                                          rows[n]})
        check(dict(core._lane_of) == lane_of,
              f"{name}: lanes {core._lane_of}, {lane_of} expected")
        park_lanes = [lane_of[n] for n in parked]
        before = [c[:, park_lanes].clone() for c in engine.carry]
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        served = dict(zip(reqs, in_threads([
            lambda n=n: [http_post(base, "/v1/step", p) for p in reqs[n]]
            for n in reqs])))
        wall = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters.items()}
        health = core.healthz()
        restored = all(bool(torch.equal(c[:, park_lanes], b))
                       for c, b in zip(engine.carry, before))
    check_decoder_launches(name, launches, quantize)
    check(restored, f"{name}: a parked lane's carry row changed")
    total = len(reqs) * steps
    check(health["steps"] == total, f"{name}: healthz {health}")
    bad = replay_lanes(torch, np, core.cfg, tok, engine, core.lanes, lane_of,
                       reqs, rows, served, steps)
    check(not bad, f"{name}: served lanes differ from step_batch: {bad}")
    exits = {n: [o["exit_layer"] for o in served[n]] for n in reqs}
    step_ms = [o["step_ms"] for n in reqs for o in served[n]]
    out = {"phase": name, "config": "deer_3b", "lanes": core.lanes,
           "window_ms": core.window_s * 1e3, "streams": len(reqs),
           "parked_streams": len(parked), "steps_per_stream": steps,
           "frame_rows_per_lane": folded_window(core.cfg),
           "exit_layers": exits, "bit_equal_to_step_batch": True,
           "parked_carry_restored": True, "wall_s": wall,
           "actions_per_s": total / wall,
           "dispatches": health["dispatches"],
           "lanes_per_dispatch": total / health["dispatches"],
           "avg_wasted_layers_per_step":
               health["avg_wasted_layers_per_step"],
           "dispatch_ms": step_ms,
           "dispatch_median_ms": statistics.median(step_ms),
           "launches": launches,
           "launches_per_dispatch": {k: v / health["dispatches"]
                                     for k, v in launches.items()}}
    emit(out)
    return out


def phase_serve_http_batched(torch, np, pol, tok, profiles: dict) -> dict:
    """``BatchedActionServer`` around ``pol`` at BATCH_LANES lanes and a
    BATCH_WINDOW_MS window: BATCH_STREAMS concurrent streams, a threshold
    profile each, HTTP_STEPS steps each, and two parked streams
    (``batched_run``)."""
    from deer_vla_tpu_torch.serving.batcher import BatchedActionServer
    kinds = list(profiles)
    names = [f"lane{i}" for i in range(BATCH_STREAMS)]
    reqs = {n: [http_payload(np, n, 6000 + 100 * i + t,
                             HTTP_INSTRUCTIONS[i])
                for t in range(HTTP_STEPS)] for i, n in enumerate(names)}
    rows = {n: profiles[kinds[i % len(kinds)]] for i, n in enumerate(names)}
    core = BatchedActionServer(pol, tok, lanes=BATCH_LANES,
                               window_ms=BATCH_WINDOW_MS)
    parked = [f"parked{i}" for i in range(BATCH_LANES - BATCH_STREAMS)]
    return batched_run(torch, np, core, pol, tok, "serve_http_batched", reqs,
                       rows, parked, HTTP_STEPS)


def phase_serve_http_variants(torch, np, cfg, base: dict, profiles: dict
                              ) -> list:
    """The diffusion head per stream (``DiffusionSamplerPolicy``, DDIM
    with DDIM_STEPS evaluations; DIFF_HTTP streams x steps over HTTP, each
    stream's (k, 7) plans bit-equal to a local adapter around its own view
    of the sampler), then vit_concat + use_state on BATCH_LANES lanes
    (FOLDED_HTTP streams x steps, robot_obs with every request, each lane
    bit-equal to its replay through step_batch), on the variant draws."""
    from deer_vla_tpu_torch.eval.diffusion_policy import \
        DiffusionSamplerPolicy
    from deer_vla_tpu_torch.eval.rollout import CalvinPolicyAdapter
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    from deer_vla_tpu_torch.serving.batcher import BatchedActionServer
    from deer_vla_tpu_torch.serving.server import (DeerActionServer,
                                                   engine_mode)
    results = []
    tok, hcfg = serving_tokenizer(variant_config(
        cfg, {"head_type": "diffusion"}))
    p = head_weights(torch, np, base, hcfg)
    pol = ScanDeerPolicy(p, hcfg, indexed_mm=True)
    pol.set_thresholds(profiles["calibrated"])
    sampler = DiffusionSamplerPolicy(pol, p, seed=SEED,
                                     sample_steps=DDIM_STEPS)
    core = DeerActionServer(sampler, tok)
    n_streams, steps = DIFF_HTTP
    names = [f"diff{i}" for i in range(n_streams)]
    reqs = {n: [http_payload(np, n, 7000 + 100 * i + t,
                             HTTP_INSTRUCTIONS[i]) for t in range(steps)]
            for i, n in enumerate(names)}
    counters = kernel_counters()
    with serving(core) as url:
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        served = dict(zip(names, in_threads([
            lambda n=n: [http_post(url, "/v1/step", q) for q in reqs[n]]
            for n in names])))
        wall = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters.items()}
    check_decoder_launches("serve_http_diffusion", launches, None)
    k = max(1, hcfg.window_size - (hcfg.n_obs_steps - 1))  # plan rows
    bad = []
    for n in names:
        local = CalvinPolicyAdapter(DeerActionServer._clone_policy(sampler),
                                    tok, text_len=hcfg.text_len)
        with engine_mode(pol.device):
            for t, (q, out) in enumerate(zip(reqs[n], served[n])):
                rgb, grip = frames_of(np, q)
                local.policy.set_timestep(t)
                want = local.step({"rgb_obs": {"rgb_static": rgb,
                                               "rgb_gripper": grip}},
                                  q["instruction"])
                plan = np.asarray(out["action"], np.float32)
                if (plan.shape != (k, 7) or not np.isfinite(plan).all()
                        or not np.array_equal(plan, want, equal_nan=True)
                        or out["exit_layer"] != local.current_exit_layer):
                    bad.append((n, t, plan.shape, out["exit_layer"],
                                local.current_exit_layer,
                                float(np.isfinite(plan).mean()),
                                float(np.nanmax(np.abs(plan - want)))
                                if plan.shape == want.shape else None))
    check(not bad, f"serve_http_diffusion: plans differ from the local "
                   f"sampler's: {bad}")
    step_ms = [o["step_ms"] for n in names for o in served[n]]
    out = {"phase": "serve_http_diffusion", "config": "deer_3b",
           "ddim_steps": DDIM_STEPS, "streams": n_streams,
           "steps_per_stream": steps, "plan_shape": [k, 7],
           "exit_layers": {n: [o["exit_layer"] for o in served[n]]
                           for n in names},
           "bit_equal_to_local_sampler": True, "step_ms": step_ms,
           "step_median_ms": statistics.median(step_ms), "wall_s": wall,
           "launches": launches}
    emit(out)
    results.append(out)
    del core, sampler, pol, p
    torch.cuda.empty_cache()

    tok, vcfg = serving_tokenizer(variant_config(
        cfg, {"fusion_mode": "vit_concat", "use_state": True}))
    p = variant_weights(torch, base, vcfg)
    pol = ScanDeerPolicy(p, vcfg, indexed_mm=True)
    pol.set_thresholds(profiles["calibrated"])
    n_streams, steps = FOLDED_HTTP
    r = np.random.RandomState(8000)
    names = [f"folded{i}" for i in range(n_streams)]
    reqs = {}
    for i, n in enumerate(names):
        reqs[n] = []
        for t in range(steps):
            ro = r.uniform(-1, 1, vcfg.state_dim).astype(np.float32)
            ro[-1] = 1.0 if r.rand() > 0.5 else -1.0  # CALVIN's gripper
            reqs[n].append(http_payload(np, n, 8000 + 100 * i + t,
                                        HTTP_INSTRUCTIONS[i], robot_obs=ro))
    kinds = list(profiles)
    rows = {n: profiles[kinds[i % len(kinds)]] for i, n in enumerate(names)}
    core = BatchedActionServer(pol, tok, lanes=BATCH_LANES,
                               window_ms=BATCH_WINDOW_MS)
    results.append(batched_run(torch, np, core, pol, tok,
                               "serve_http_batched_vit_concat_state", reqs,
                               rows, [], steps))
    del core, pol, p
    torch.cuda.empty_cache()
    return results


def phase_serve_cli(torch, np) -> dict:
    """``cli/serve`` in-process on the card: ``main`` with --thresholds and
    --oneshot_healthz on a seeded deer_3b (binds, prints healthz, exits),
    then ``build_core`` on the training phase's checkpoint, whose
    calibration values sidecar phase train_eval wrote: the sidecar's
    thresholds (solved at --exit_ratio) must reach the engine, and two
    steps are served with the kernel counts set to 0 before."""
    import io
    from deer_vla_tpu_torch.cli import serve as serve_cli
    from deer_vla_tpu_torch.core.config import deer_3b
    from deer_vla_tpu_torch.models.value_net import solve_thresholds
    from deer_vla_tpu_torch.train.checkpoint import load_calibration_values
    exits = list(deer_3b().all_exit_ids())
    argv = ["--model", "deer_3b", "--port", "0", "--oneshot_healthz",
            "--thresholds"] + ["1e-4"] * (len(exits) - 1) + ["1e30"]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve_cli.main(argv)
    oneshot_s = time.perf_counter() - t0
    lines = [json.loads(x) for x in buf.getvalue().strip().splitlines()]
    check(rc == 0 and lines[0]["device"].startswith("cuda")
          and lines[1]["exits"] == exits and lines[1]["ok"],
          f"serve_cli: --oneshot_healthz printed {lines}")
    torch.cuda.empty_cache()
    ckpt = str(SERVE_CLI_DIR / "deer_1.ckpt")
    values = load_calibration_values(ckpt)
    check(values is not None, f"serve_cli: no values sidecar beside {ckpt}")
    args = serve_cli.build_parser().parse_args([
        "--model", "deer_3b", "--evaluate_from_checkpoint", ckpt,
        "--exit_ratio", "0.5"])
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        core, cfg = serve_cli.build_core(args)
    build_s = time.perf_counter() - t0
    th, _ = solve_thresholds(values, 0.5, exits, max_layer=exits[-1] + 1,
                             model_name="deer_3b")
    row = core._base.thresholds.cpu().numpy()
    check(all(row[e] == np.float32(th[e]) for e in exits[:-1]),
          f"serve_cli: engine thresholds {row} != the sidecar's {th}")
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    outs = [core.step(http_payload(np, "cli", 9000 + t,
                                   HTTP_INSTRUCTIONS[0])) for t in range(2)]
    launches = {k: f.launches for k, f in counters.items()}
    check_decoder_launches("serve_cli", launches, None)
    check(all(len(o["action"]) == 7 and np.isfinite(o["action"]).all()
              for o in outs), f"serve_cli: steps {outs}")
    out = {"phase": "serve_cli", "oneshot_argv": argv,
           "oneshot_seconds": oneshot_s, "healthz": lines[1],
           "checkpoint": ckpt, "build_core_seconds": build_s,
           "sidecar_thresholds": {str(e): float(th[e]) for e in exits},
           "exit_layers": [o["exit_layer"] for o in outs],
           "step_ms": [o["step_ms"] for o in outs], "launches": launches}
    emit(out)
    del core
    torch.cuda.empty_cache()
    return out


def phase_rollout_tcp(torch, np) -> dict:
    """``cli/gen_sequences`` writes the sequences and the annotation cache,
    then ``cli/eval --debug --tcp_rel --diverse_inst --annotation_cache``
    at deer_3b (``phase_rollout``'s checks); then the trainer's
    ``prepare_batch`` with ``tcp_rel`` on the card against the CPU, for
    single-step and (B, W, 3, 7) multi-step labels."""
    import io
    from deer_vla_tpu_torch.cli import gen_sequences
    from deer_vla_tpu_torch.core.config import deer_3b
    from deer_vla_tpu_torch.train.trainer import TrainConfig, prepare_batch
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cache = OUT_DIR / "lang_annotation_cache.json"
    with contextlib.redirect_stdout(io.StringIO()):
        gen_sequences.main(["--num_sequences", "2", "--out_sequences",
                            str(OUT_DIR / "eval_sequences.json"),
                            "--out_annotation_cache", str(cache)])
    out = phase_rollout(torch, np, "rollout_tcp", ROLLOUT_ARGV + [
        "--tcp_rel", "--diverse_inst", "--annotation_cache", str(cache)])
    cfg, batches = calib_debug_batches(deer_3b(), 2, 1)
    raw = batches[0]
    tcfg = TrainConfig(tcp_rel=True, rgb_pad=0, gripper_pad=0)
    errs = {}
    for k in (1, 3):
        if k > 1:
            a = np.asarray(raw["actions"])
            raw = dict(raw, actions=np.stack([a] * k, axis=2))
        card = prepare_batch(raw, cfg, None, tcfg, "cuda")["labels"]
        cpu = prepare_batch(raw, cfg, None, tcfg, "cpu")["labels"]
        errs[k] = float((card.cpu() - cpu).abs().max())
        check(card.shape == raw["actions"].shape and errs[k] <= TCP_LABEL_TOL,
              f"rollout_tcp: tcp labels k={k}: card against CPU {errs[k]}")
    out["tcp_labels_max_abs_err"] = errs
    out["tcp_labels_tolerance"] = TCP_LABEL_TOL
    emit({"phase": "rollout_tcp_labels", "max_abs_err": errs,
          "tolerance": TCP_LABEL_TOL})
    return out


# ---------------------------------------------------------------------------
# the tooling (ROADMAP M17): reference-checkpoint conversion, the threshold
# search, checkpoint sweeps, profiling
# ---------------------------------------------------------------------------

CONVERT_DIR = REPO / "build" / "chip_smoke_convert"
# every leaf of convert_3b's tree gets a seeded normal draw of this scale
# on top of the seeded init, so that no leaf holds a constant (LayerNorm
# scales and biases included) and no two leaves hold the same values: a
# converter that swaps, drops or redraws a leaf cannot give the same tree
CONVERT_LEAF_STD = 0.01
# the DeeR dict's readouts (eval_calvin.py:455-476) at deer_3b's values and
# its cached calibration values: (exits, samples)
CONVERT_VALUES = 64
# convert_3b's decoder depth: deer_3b's widths with 2 of its 12 layers (its
# 12-layer tree, 7.6 GB of artifacts, took 83.8 s on an H100 host against
# the script's 900 s, 4 layers 35.1 s; every layer converts by the same
# name map)
CONVERT_DEPTH = 2
# cli/bayes_opt at deer_3b: the initial cli/eval run (8 calibration batches,
# 2 sequential rollout sequences), then 2 GP rounds of 2 candidates, each
# round one batched rollout over 2 lanes a candidate
BO_Q, BO_LANES_PER = 2, 2
BO_LANES = BO_Q * BO_LANES_PER  # the ViT batch of a round's dispatch
BO_ARGV = ["--debug", "--model", "mpt_dolly_3b", "--parallel", str(BO_Q),
           "--lanes_per_candidate", str(BO_LANES_PER), "--n_calls", "4",
           "--num_seq", "2"]
# cli/eval_ckpts on the training phase's last checkpoint: a bf16 sweep at
# ratio 0.5 that serves the checkpoint's values sidecar (cli/eval's default
# cache) and an int8 sweep at ratio 1.0 that calibrates under K3 into a
# cache of its own; arguments after "--" for cli/eval
SWEEP_LOG_DIR = OUT_DIR / "eval_ckpts"
SWEEP_RUNS = (("bf16", "0.5", []),
              ("int8", "1.0", ["--quantize", "int8", "--value_cache",
                               str(TRAIN_DIR / "sweep_int8_values")]))
SWEEP_EVAL_ARGS = ["--calib_batches", "2", "--num_sequences_override", "2",
                   "--ep_len", "40"]
# Timer(sync_on=) against the host clock of the same served step
TIMER_REL_TOL = 0.10
# ... and around a device-bound block with no host read: a chain of bf16
# (n, n) products, about 10 ms of the card's time.  The synced Timer must
# span the CUDA events recorded around the same work (to the events'
# resolution, TIMER_EVENT_SLACK_MS); an unsynced one must read less than
# TIMER_UNSYNCED_SHARE of them
TIMER_MM_N, TIMER_MM_CHAIN = 8192, 8
TIMER_EVENT_SLACK_MS = 0.01
TIMER_UNSYNCED_SHARE = 0.5


def ln_keys(prefix: str, ln: dict) -> dict:
    """A LayerNorm leaf as torch names it."""
    out = {prefix + ".weight": ln["scale"]}
    if "bias" in ln:
        out[prefix + ".bias"] = ln["bias"]
    return out


def linear_keys(prefix: str, lin: dict) -> dict:
    """A linear leaf as torch names it: the weight (out, in)."""
    out = {prefix + ".weight": lin["w"].T}
    if "b" in lin:
        out[prefix + ".bias"] = lin["b"]
    return out


def reference_vit(vit: dict) -> dict:
    """The ViT as a raw open_clip checkpoint (``visual.*``)."""
    pe = vit["patch_embed"]["w"]  # (3 * p * p, width)
    p = int(round((pe.shape[0] // 3) ** 0.5))
    sd = {"visual.conv1.weight": pe.T.reshape(pe.shape[1], 3, p, p),
          "visual.class_embedding": vit["class_embedding"],
          "visual.positional_embedding": vit["positional_embedding"],
          **ln_keys("visual.ln_pre", vit["ln_pre"]),
          **ln_keys("visual.ln_post", vit["ln_post"])}
    for i, b in enumerate(vit["blocks"]):
        rb = f"visual.transformer.resblocks.{i}."
        sd.update(ln_keys(rb + "ln_1", b["ln_1"]))
        sd.update(ln_keys(rb + "ln_2", b["ln_2"]))
        sd[rb + "attn.in_proj_weight"] = b["qkv"]["w"].T
        sd[rb + "attn.in_proj_bias"] = b["qkv"]["b"]
        sd.update(linear_keys(rb + "attn.out_proj", b["out"]))
        sd.update(linear_keys(rb + "mlp.c_fc", b["mlp_fc"]))
        sd.update(linear_keys(rb + "mlp.c_proj", b["mlp_proj"]))
    return sd


def reference_mpt_shards(decoder: dict) -> list:
    """The MPT decoder as an HF snapshot's state dict in two shards: wte
    and the first half of the blocks, then the rest and ln_f."""
    blocks = decoder["blocks"]
    half = len(blocks) // 2
    shards = [{"transformer.wte.weight": decoder["wte"]["w"]},
              ln_keys("transformer.ln_f", decoder["ln_f"])]
    for i, b in enumerate(blocks):
        pre = f"transformer.blocks.{i}."
        sd = shards[0 if i < half else 1]
        sd.update(ln_keys(pre + "ln_1", b["ln_1"]))
        sd.update(ln_keys(pre + "ln_2", b["ln_2"]))
        sd.update(linear_keys(pre + "attn.Wqkv", b["wqkv"]))
        sd.update(linear_keys(pre + "attn.out_proj", b["out_proj"]))
        sd.update(linear_keys(pre + "mlp.mlp_up", b["mlp_up"]))
        sd.update(linear_keys(pre + "mlp.mlp_down", b["mlp_down"]))
    return shards


def reference_head(prefix: str, head: dict) -> dict:
    """A DeterministicDecoder: nn.LSTM names and the two MLP heads'
    Linear layers at Sequential indices 0, 2, 4, ..."""
    sd = {}
    for k, lp in enumerate(head["rnn"]["layers"]):
        sd[f"{prefix}rnn.weight_ih_l{k}"] = lp["wi"].T
        sd[f"{prefix}rnn.weight_hh_l{k}"] = lp["wh"].T
        sd[f"{prefix}rnn.bias_ih_l{k}"] = lp["bi"]
        sd[f"{prefix}rnn.bias_hh_l{k}"] = lp["bh"]
    for name in ("actions", "gripper"):
        for j, lin in enumerate(head[name]["layers"]):
            sd.update(linear_keys(f"{prefix}{name}.mlp.{2 * j}", lin))
    return sd


def reference_delta(params: dict, cfg) -> dict:
    """The DeeR delta's state dict: the perceiver, wte, the gated x-attn
    layers and the heads, named as the composed reference model names
    them."""
    per = params["perceiver"]
    sd = {"perceiver.latents": per["latents"],
          **ln_keys("perceiver.norm", per["norm"]),
          "lang_encoder.transformer.wte.weight":
              params["decoder"]["wte"]["w"]}
    for i, layer in enumerate(per["layers"]):
        a, f = f"perceiver.layers.{i}.0.", f"perceiver.layers.{i}.1."
        sd.update(ln_keys(a + "norm_media", layer["norm_media"]))
        sd.update(ln_keys(a + "norm_latents", layer["norm_latents"]))
        for name in ("to_q", "to_kv", "to_out"):
            sd.update(linear_keys(a + name, layer[name]))
        sd.update(ln_keys(f + "0", layer["ff"]["ln"]))
        sd.update(linear_keys(f + "1", layer["ff"]["fc1"]))
        sd.update(linear_keys(f + "3", layer["ff"]["fc2"]))
    for i, x in enumerate(params["decoder"]["xattn"]):
        if x is None:
            continue
        pre = f"lang_encoder.transformer.blocks.{i}.gated_cross_attn_layer."
        sd.update(ln_keys(pre + "attn.norm", x["norm"]))
        for name in ("to_q", "to_kv", "to_out"):
            sd.update(linear_keys(pre + "attn." + name, x[name]))
        sd[pre + "attn_gate"] = x["attn_gate"]
        sd[pre + "ff_gate"] = x["ff_gate"]
        sd.update(ln_keys(pre + "ff.0", x["ff"]["ln"]))
        sd.update(linear_keys(pre + "ff.1", x["ff"]["fc1"]))
        sd.update(linear_keys(pre + "ff.3", x["ff"]["fc2"]))
    sd.update(reference_head("lm_head.", params["lm_head"]))
    sd.update(reference_head("extra_exit.", params["extra_exit"]))
    for j, layer_id in enumerate(cfg.exit_layer_ids()):
        sd.update(reference_head(f"lm_exit_modules.{j}.",
                                 params["lm_exits"][str(layer_id)]))
    return sd


def write_safetensors(np, path: Path, tensors: dict) -> int:
    """A .safetensors file of fp32 numpy arrays, written by hand: the
    8-byte little-endian header length, the JSON header (dtype, shape,
    data_offsets), the little-endian data.  Returns the bytes written."""
    import struct
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, a in tensors.items():
        n = a.size * 4
        header[name] = {"dtype": "F32", "shape": list(a.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)  # the format pads the header to 8
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)) + text)
        for a in tensors.values():
            f.write(np.ascontiguousarray(a, dtype="<f4").tobytes())
    return 8 + len(text) + offset


def distinct_leaves(torch, params: dict) -> None:
    """Adds a seeded normal draw of ``CONVERT_LEAF_STD`` to every leaf of
    ``params``, in place."""
    from deer_vla_tpu_torch.ops.layers import tree_leaves_with_path
    leaves = tree_leaves_with_path(params)
    gen = torch.Generator(device=leaves[0][1].device).manual_seed(SEED + 2)
    for _, t in leaves:
        t.add_(torch.randn(t.shape, generator=gen, device=t.device,
                           dtype=t.dtype), alpha=CONVERT_LEAF_STD)


def write_reference_artifacts(torch, np, params: dict, cfg, out: Path,
                              values) -> dict:
    """``params`` (the tree of fp32 tensors, on the card) in the
    reference's layouts: the ViT as an open_clip ``.pt``, the MPT blocks
    and wte as an HF snapshot of two ``.safetensors`` shards, the
    perceiver, x-attn, wte and heads as a DeeR delta ``.pth`` with the
    readout keys and a ``values`` tensor.  Each tensor is laid out where
    it lies (the transposes on the card) and copied to the host as it is
    written.  Returns the files' paths and their bytes."""
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)

    def tensors(sd):
        return {k: v.contiguous().cpu() for k, v in sd.items()}

    files = {"clip": out / "open_clip_vit_l14.pt",
             "mpt": out / "mpt_snapshot",
             "deer": out / "deer_delta.pth"}
    torch.save(tensors(reference_vit(params["vit"])), files["clip"])
    files["mpt"].mkdir()
    shards = reference_mpt_shards(params["decoder"])
    for i, sd in enumerate(shards):
        write_safetensors(np, files["mpt"] / f"model-0000{i + 1}-of-0000"
                                             f"{len(shards)}.safetensors",
                          {k: v.numpy() for k, v in tensors(sd).items()})
    head = cfg.head
    torch.save({"model_state_dict": tensors(reference_delta(params, cfg)),
                "epoch": 3, "head_type": cfg.head_type,
                "early_exit_layer": cfg.n_layers - 1,
                "exit_interval": cfg.exit_interval,
                "multi_exit": cfg.multi_exit, "share_exit": cfg.share_exit,
                "mlp_layernorm": head.mlp_layernorm,
                "lstm_layernorm": head.lstm_layernorm,
                "mlp_num_hidden_layers": head.mlp_num_hidden_layers,
                "lstm_num_layers": head.lstm_num_layers,
                "pooling": head.pooling,
                "values": torch.from_numpy(values)}, files["deer"])
    sizes = {k: sum(f.stat().st_size for f in
                    ([p] if p.is_file() else p.iterdir()))
             for k, p in files.items()}
    return {"files": {k: str(p) for k, p in files.items()}, "bytes": sizes}


# cli/convert in a process of its own, which samples its own resident set
# (/proc/self/statm) every 50 ms and prints the largest (the rusage of a
# child also holds the image it was forked from, and the card's machine has
# no VmHWM in /proc/self/status), and the seconds spent in its draw of the
# init, its loads of the backbone sources and its checkpoint write
CONVERT_MAIN = """
import json, os, sys, threading, time
import deer_vla_tpu_torch.models.flamingo as flamingo
import deer_vla_tpu_torch.train.checkpoint as checkpoint
import deer_vla_tpu_torch.utils.convert as convert
from deer_vla_tpu_torch.cli.convert import main
peak, page, spent = [0], os.sysconf("SC_PAGE_SIZE"), {}
def sample():
    try:
        while True:
            with open("/proc/self/statm") as f:
                peak[0] = max(peak[0], int(f.read().split()[1]) * page)
            time.sleep(0.05)
    except OSError:
        peak[0] = None
def timed(mod, name):
    real = getattr(mod, name)
    def call(*a, **k):
        t0 = time.perf_counter()
        try:
            return real(*a, **k)
        finally:
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
    setattr(mod, name, call)
for mod, name in ((flamingo, "init_deer"), (convert, "load_torch_checkpoint"),
                  (checkpoint, "save_checkpoint")):
    timed(mod, name)
threading.Thread(target=sample, daemon=True).start()
t0 = time.perf_counter()
main(sys.argv[1:])
spent["main"] = time.perf_counter() - t0
print("PEAK_RSS_BYTES", peak[0], flush=True)
print("SECONDS", json.dumps(spent), flush=True)
"""


def run_convert(files: dict, stem: Path, seed: int,
                model: str = "deer_3b") -> dict:
    """``cli/convert.main`` on the artifacts in a process of its own:
    its seconds (the process's and its parts'), its output and its peak
    RSS (None where the machine cannot say)."""
    argv = ["--model", model, "--clip_checkpoint", files["clip"],
            "--mpt_checkpoint", files["mpt"], "--deer_checkpoint",
            files["deer"], "--seed", str(seed), "--out", str(stem)]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CONVERT_MAIN] + argv,
                          cwd=REPO, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    text = proc.stdout + proc.stderr
    check(proc.returncode == 0,
          f"convert_3b: cli/convert exited {proc.returncode}: {text[-2000:]}")
    peak = re.search(r"PEAK_RSS_BYTES (\d+|None)", proc.stdout)
    parts = re.search(r"SECONDS (\{.*\})", proc.stdout)
    check(peak is not None and parts is not None,
          f"convert_3b: no peak RSS or seconds in {text[-500:]}")
    return {"argv": argv, "seconds": seconds, "log": text,
            "parts_seconds": json.loads(parts.group(1)),
            "peak_rss_gb": (None if peak.group(1) == "None"
                            else int(peak.group(1)) / 1e9)}


def phase_convert_3b(torch, np, cfg) -> dict:
    """The seeded deer_3b tree (``build_weights``), every leaf made
    distinct (``distinct_leaves``), written as the reference's artifacts
    (``write_reference_artifacts``), converted by ``cli/convert`` with a
    seed of its own for the leaves no source covers: every converted leaf
    must be bit-equal to the written one, each source's audit at 0
    unconsumed keys, the config the seeded model's and the values sidecar
    the values written.  Then 8 B=1 steps of the converted and the written
    trees, each through ``ScanDeerPolicy`` with K2, from the same inputs
    and thresholds: exits and actions bit-equal, K1 and K2 launched on the
    converted run."""
    from deer_vla_tpu_torch.core.config import DeerConfig
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    from deer_vla_tpu_torch.ops.layers import (flat_key, tree_leaves_with_path,
                                               tree_map)
    from deer_vla_tpu_torch.train.checkpoint import (load_calibration_values,
                                                     load_checkpoint)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    params = build_weights(torch, cfg)
    distinct_leaves(torch, params)
    t0 = time.perf_counter()
    values = np.random.RandomState(SEED).uniform(
        0, 1e-3, (cfg.num_exits, CONVERT_VALUES)).astype(np.float32)
    written = write_reference_artifacts(torch, np, params, cfg, CONVERT_DIR,
                                        values)
    write_s = time.perf_counter() - t0
    stem = CONVERT_DIR / "converted" / "deer"
    conv = run_convert(written["files"], stem, seed=SEED + 1)
    side = json.loads((stem.parent / "deer.json").read_text())
    sources = side["meta"]["converted_from"]
    check([s["role"] for s in sources] == ["clip_vit", "mpt_backbone",
                                           "deer_delta"]
          and all(s["unconsumed"] == 0 for s in sources),
          f"convert_3b: sources {sources}")
    ccfg = DeerConfig.from_json(json.dumps(side["config"]))
    check(ccfg.to_json() == cfg.to_json(),
          "convert_3b: the converted config is not the seeded model's")
    t0 = time.perf_counter()
    template = tree_map(torch.zeros_like, params)
    conv_params, _, loaded = load_checkpoint(str(stem), template)
    load_s = time.perf_counter() - t0
    del template
    leaves = tree_leaves_with_path(params)
    got = dict((flat_key(p), t) for p, t in tree_leaves_with_path(
        conv_params))
    unequal = [flat_key(p) for p, t in leaves
               if not torch.equal(got[flat_key(p)], t)]
    check(loaded["meta"]["loaded_keys"] == len(leaves) and not unequal,
          f"convert_3b: {loaded['meta']['loaded_keys']} of {len(leaves)} "
          f"leaves loaded, unequal {unequal[:5]}")
    sidecar = load_calibration_values(str(stem))
    check(sidecar is not None and np.array_equal(sidecar, values),
          "convert_3b: the values sidecar differs from the values written")
    del got

    counters = kernel_counters()
    runs = {}
    for name, tree in (("written", params), ("converted", conv_params)):
        pol = ScanDeerPolicy(tree, cfg, indexed_mm=True)
        n_exits = len(pol.exits)
        for f in counters.values():
            f.launches = 0
        acts, exits, ms = [], [], []
        for s in range(8):
            pol.set_thresholds([SWEEP[s]] * n_exits)
            t1 = time.perf_counter()
            acts.append(pol.step(*make_policy_inputs(np, cfg, 1, 700 + s)))
            ms.append((time.perf_counter() - t1) * 1e3)
            exits.append(pol.last_exit_layer)
        runs[name] = {"actions": acts, "exit_layers": exits, "step_ms": ms,
                      "launches": {n: f.launches
                                   for n, f in counters.items()}}
        del pol
        torch.cuda.empty_cache()
    want, converted = runs["written"], runs["converted"]
    check(want["exit_layers"] == converted["exit_layers"]
          and all(np.array_equal(a, b) for a, b in
                  zip(want["actions"], converted["actions"])),
          f"convert_3b: converted steps differ: exits "
          f"{converted['exit_layers']} against {want['exit_layers']}")
    launches = converted["launches"]
    check(launches["flash_attention"] > 0 and launches["indexed_matmul"] > 0,
          f"convert_3b: K1 / K2 not launched: {launches}")
    out = {"phase": "convert_3b", "write_seconds": write_s,
           "artifact_bytes": written["bytes"],
           "convert_argv": conv["argv"], "convert_seconds": conv["seconds"],
           "convert_parts_seconds": conv["parts_seconds"],
           "convert_peak_rss_gb": conv["peak_rss_gb"],
           "checkpoint_bytes": (stem.parent / "deer.ckpt").stat().st_size,
           "load_seconds": load_s, "sources": sources,
           "leaves": len(leaves), "leaves_bit_equal": len(leaves),
           "exit_layers": converted["exit_layers"],
           "step_ms": converted["step_ms"],
           "written_step_ms": want["step_ms"], "launches": launches}
    (OUT_DIR / "cli_convert.log").write_text(conv["log"])
    emit(out)
    del params, conv_params
    shutil.rmtree(CONVERT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def batched_rollouts(calls: list):
    """While open, each ``evaluate_policy_batched`` call is timed and
    appended to ``calls`` with its env steps and its arguments."""
    from deer_vla_tpu_torch.eval import batched_rollout
    real = batched_rollout.evaluate_policy_batched

    def timed(policy, envs, *args, **kw):
        steps = sum(e.steps for e in envs)
        t0 = time.perf_counter()
        reports = real(policy, envs, *args, **kw)
        calls.append({"seconds": time.perf_counter() - t0,
                      "env_steps": sum(e.steps for e in envs) - steps,
                      "policy": policy, "envs": envs, "args": args,
                      "kw": kw})
        return reports

    batched_rollout.evaluate_policy_batched = timed
    try:
        yield calls
    finally:
        batched_rollout.evaluate_policy_batched = real


def phase_bayes_opt_3b(torch, np) -> tuple:
    """``cli/bayes_opt.main(BO_ARGV)`` in-process on the card, the kernel
    counts set to 0 before and read after: it must print its optimum and a
    ``BO eval`` line a candidate, with K1 and K2 launched; each GP round
    (one batched rollout of ``BO_LANES`` lanes) is timed.  Then the last
    round's engine, envs and sequences run ``evaluate_policy_batched``
    with two candidates, the first-exit row and the full-depth row: each
    candidate's exits must sit wholly at the first and the last exit.
    Returns the phase's record and that engine (for phase profiling)."""
    import io
    from deer_vla_tpu_torch.cli import bayes_opt
    from deer_vla_tpu_torch.eval import batched_rollout
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    calls, buf = [], io.StringIO()
    t0 = time.perf_counter()
    with batched_rollouts(calls), contextlib.redirect_stdout(buf):
        result = bayes_opt.main(BO_ARGV)
    seconds = time.perf_counter() - t0
    launches = {n: f.launches for n, f in counters.items()}
    text = buf.getvalue()
    (OUT_DIR / "cli_bayes_opt.log").write_text(text)
    evals = re.findall(r"BO eval .*", text)
    check("Optimal thresholds:" in text and len(evals) >= 4
          and len(calls) == 2 and np.isfinite(result.fun),
          f"bayes_opt_3b: {len(evals)} BO eval lines, {len(calls)} rounds")
    check(launches["flash_attention"] > 0 and launches["indexed_matmul"] > 0,
          f"bayes_opt_3b: K1 / K2 not launched: {launches}")
    last = calls[-1]
    policy, envs = last["policy"], last["envs"]
    sequences, annotations, oracle, tok = last["args"][:4]
    exits = policy.exits
    cands = [[1e8] * len(exits), [-1e8] * (len(exits) - 1) + [1e8]]
    reports = batched_rollout.evaluate_policy_batched(
        policy, envs, sequences, annotations, oracle, tok,
        text_len=last["kw"]["text_len"], ep_len=last["kw"]["ep_len"],
        n_layers=last["kw"]["n_layers"], candidates=cands)
    hists = [np.add(r["success_exit_hist"], r["fail_exit_hist"])
             for r in reports]
    check(all(h.sum() > 0 for h in hists)
          and hists[0][exits[0]] == hists[0].sum()
          and hists[1][exits[-1]] == hists[1].sum(),
          f"bayes_opt_3b: candidate exits {[h.tolist() for h in hists]}")
    rounds = [{"seconds": c["seconds"], "env_steps": c["env_steps"],
               "steps_per_s": c["env_steps"] / c["seconds"]} for c in calls]
    out = {"phase": "bayes_opt_3b", "argv": BO_ARGV, "seconds": seconds,
           "init_seconds": seconds - sum(r["seconds"] for r in rounds),
           "rounds": rounds,
           "round_seconds_median": statistics.median(
               r["seconds"] for r in rounds),
           "round_steps_per_s": sum(r["env_steps"] for r in rounds)
           / sum(r["seconds"] for r in rounds),
           "bo_evals": evals, "best_x": [float(x) for x in result.x],
           "best_score": float(result.fun),
           "candidate_exit_hists": [h.tolist() for h in hists],
           "launches": launches}
    emit(out)
    return out, policy


def phase_eval_ckpts(torch, np) -> dict:
    """``cli/eval_ckpts --debug`` on the training phase's last checkpoint,
    in-process on the card: a bf16 sweep at ratio 0.5 (K1, K2) on the
    checkpoint's values sidecar, which must not calibrate, and an int8
    sweep at ratio 1.0 (K1, K3 and no K2) with a cache of its own, which
    must; kernel counts set to 0 before each; a second call of each skips
    its log; every log ends in the parse contract and every report
    parses."""
    import io
    from deer_vla_tpu_torch.cli import eval_ckpts
    shutil.rmtree(SWEEP_LOG_DIR, ignore_errors=True)
    counters = kernel_counters()
    runs = {}
    for name, ratio, extra in SWEEP_RUNS:
        argv = ["--ckpt_dir", str(TRAIN_DIR), "--log_dir",
                str(SWEEP_LOG_DIR), "--pattern", "deer_1.ckpt",
                "--exit_ratio", ratio, "--debug", "--num_seq", "2", "--"] \
            + SWEEP_EVAL_ARGS + extra
        for f in counters.values():
            f.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = eval_ckpts.main(argv)
        seconds = time.perf_counter() - t0
        launches = {n: f.launches for n, f in counters.items()}
        stem = SWEEP_LOG_DIR / f"deer_1_ratio{float(ratio)}"
        tail = Path(f"{stem}.log").read_text().strip().splitlines()[-3:]
        report = json.loads(Path(f"{stem}.json").read_text())
        check(rc == 0 and "result:" in buf.getvalue()
              and abs(float(tail[1]) - report["report"]["avg_seq_len"])
              < 1e-5 and report["exit_ratio"] == float(ratio),
              f"eval_ckpts {name}: rc {rc}, tail {tail}")
        calibrated = "calibrated " in Path(f"{stem}.log").read_text()
        check(calibrated == (name == "int8"),
              f"eval_ckpts {name}: calibrated {calibrated}")
        decoder = DECODER_KERNEL[None if name == "bf16" else name]
        others = set(DECODER_KERNEL.values()) - {decoder}
        check(launches["flash_attention"] > 0 and launches[decoder] > 0
              and all(launches[k] == 0 for k in others),
              f"eval_ckpts {name}: launches {launches}")
        runs[name] = {"argv": argv, "seconds": seconds, "launches": launches,
                      "calibrated": calibrated,
                      "avg_seq_len": report["report"]["avg_seq_len"],
                      "avg_exit_layer": report["report"]["avg_exit_layer"],
                      "contract": tail}
    for name, ratio, extra in SWEEP_RUNS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            eval_ckpts.main(runs[name]["argv"])
        check("skip (done)" in buf.getvalue()
              and "result:" not in buf.getvalue(),
              f"eval_ckpts {name}: the second call ran again")
    out = {"phase": "eval_ckpts", "runs": runs,
           "logs": sorted(p.name for p in SWEEP_LOG_DIR.iterdir())}
    emit(out)
    torch.cuda.empty_cache()
    return out


def timer_on_device_work(torch) -> dict:
    """``Timer`` around ``TIMER_MM_CHAIN`` bf16 products, which read
    nothing back to the host, 5 times with ``sync_on`` and 5 without,
    each beside CUDA events recorded around the same launches: the synced
    reading must hold the events' time, the unsynced one must fall well
    short of it (a Timer that ignored ``sync_on`` reads the launches
    only)."""
    from deer_vla_tpu_torch.utils.profiling import Timer
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    a = (torch.randn(TIMER_MM_N, TIMER_MM_N, device="cuda", generator=gen)
         / TIMER_MM_N ** 0.5).to(torch.bfloat16)

    def chain():
        x = a
        for _ in range(TIMER_MM_CHAIN):
            x = x @ a
        return x

    chain()  # warm the library's handles
    rows = {"synced": [], "unsynced": []}
    for _ in range(5):
        for kind in rows:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with Timer(kind) as t:
                start.record()
                x = chain()
                end.record()
                if kind == "synced":
                    t.sync_on = x
            torch.cuda.synchronize()
            rows[kind].append({"timer_ms": t.ms,
                               "event_ms": start.elapsed_time(end)})
    synced, unsynced = rows["synced"], rows["unsynced"]
    check(all(r["timer_ms"] >= r["event_ms"] - TIMER_EVENT_SLACK_MS
              for r in synced),
          f"profiling: Timer(sync_on=) reads less than the events: {synced}")
    share = statistics.median(r["timer_ms"] / r["event_ms"] for r in unsynced)
    check(share < TIMER_UNSYNCED_SHARE,
          f"profiling: an unsynced Timer reads {share} of the events")
    return {"n": TIMER_MM_N, "chain": TIMER_MM_CHAIN, "synced": synced,
            "unsynced": unsynced, "unsynced_share_median": share}


def phase_profiling(torch, np, policy) -> dict:
    """``utils/profiling`` on the card: ``timer_on_device_work``; then
    around B=1 served steps of ``policy``, ``Timer(sync_on=)`` around
    each step's device half (``run_batch``) against the host clock of the
    same step (until the actions are on the host), within
    ``TIMER_REL_TOL`` in the median of 5; ``trace()`` over one step
    writes a Chrome trace with CUDA kernels in it; ``MetricLogger``
    writes each step's times as JSONL."""
    from deer_vla_tpu_torch.utils.profiling import MetricLogger, Timer, trace
    cfg = policy.cfg
    policy.set_thresholds([1e-4] * len(policy.exits))
    policy.reset()

    def inputs(s):
        return make_policy_inputs(np, cfg, 1, 900 + s)

    device_work = timer_on_device_work(torch)
    for s in range(3):  # warm
        policy.run_batch(*inputs(s))
    torch.cuda.synchronize()
    log_path = OUT_DIR / "profiling_metrics.jsonl"
    log_path.unlink(missing_ok=True)
    logger = MetricLogger(str(log_path))
    rows = []
    for s in range(5):
        args = inputs(10 + s)
        t0 = time.perf_counter()
        with Timer("step") as t:
            out = policy.run_batch(*args)
            t.sync_on = out
        host = [o.cpu() for o in out]
        host_ms = (time.perf_counter() - t0) * 1e3
        rows.append({"step": s, "timer_ms": t.ms, "host_ms": host_ms,
                     "exit_layer": int(host[2][0])})
        logger.log(rows[-1])
    logger.close()
    timer = statistics.median(r["timer_ms"] for r in rows)
    clock = statistics.median(r["host_ms"] for r in rows)
    check(abs(timer - clock) <= TIMER_REL_TOL * clock,
          f"profiling: Timer {timer} ms against the host clock {clock} ms")
    logged = [json.loads(x) for x in log_path.read_text().splitlines()]
    check(len(logged) == 5 and all("ts" in r for r in logged),
          f"profiling: MetricLogger wrote {logged}")
    trace_dir = OUT_DIR / "trace_profiling"
    with trace(str(trace_dir)) as prof:
        out = policy.run_batch(*inputs(20))
        torch.cuda.synchronize()
    events = json.loads((trace_dir / "trace.json").read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    device_us = sum(e.get("dur", 0) for e in kernels)
    check(kernels, "profiling: the trace holds no CUDA kernel")
    out = {"phase": "profiling", "timer_on_device_work": device_work,
           "timer_ms_median": timer,
           "host_ms_median": clock, "steps": rows,
           "trace": str(trace_dir / "trace.json"),
           "trace_bytes": (trace_dir / "trace.json").stat().st_size,
           "trace_kernels": len(kernels), "trace_device_ms": device_us / 1e3,
           "top_ops": [{"name": a.key, "count": a.count}
                       for a in sorted(prof.key_averages(),
                                       key=lambda a: -a.count)[:5]]}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# the serving artifact (ROADMAP M14b): serving/export.py, cli/export
# ---------------------------------------------------------------------------

# export_3b: each mode at B=1 and B=8, traced and saved by a child process
# each, all at once (a trace costs the host milliseconds a graph node, one
# core each), then served by this process EXPORT_STEPS steps against the
# live engine (the sweep's thresholds, one row a step); deer_tiny traced on
# the CPU and on the card by two more children
EXPORT_RUNS = ((None, 1), (None, 8), ("int8", 1), ("int8", 8), ("int4", 1),
               ("int4", 8), ("tiny", "cpu"), ("tiny", "cuda"))
EXPORT_STEPS = 8
EXPORT_CHILD_TIMEOUT_S = 400
# the depth the artifacts are exported at: EXPORT_VIT_DEPTH ViT and
# EXPORT_DEPTH decoder layers (exits [1, 3]) at full width (the ViT cut from
# 4 to 2 layers paid for the fused_3b and pipeline phases: the host traces,
# saves and loads an artifact node by node)
EXPORT_DEPTH = 4
EXPORT_VIT_DEPTH = 2


def export_config():
    from deer_vla_tpu_torch.core.config import deer_3b
    return cut_depth(deer_3b(), EXPORT_DEPTH, EXPORT_VIT_DEPTH)


def export_path(root: str, rank: int) -> str:
    quantize, b = EXPORT_RUNS[rank]
    name = (f"deer_tiny_{b}" if quantize == "tiny"
            else f"deer_3b_{quantize or 'bf16'}_b{b}")
    return str(Path(root) / f"{name}.step")


def child_export(torch, rank: int, root: str) -> dict:
    """One export of export_3b: EXPORT_RUNS[rank] traced
    (``export_policy``) on a seeded draw of its config (the programs hold
    no weights, so any draw of the same shapes gives the same programs)
    and saved; its seconds and nodes."""
    from deer_vla_tpu_torch.core.config import deer_tiny
    from deer_vla_tpu_torch.models.flamingo import init_deer
    from deer_vla_tpu_torch.serving.export import (export_policy,
                                                   save_exported)
    quantize, b = EXPORT_RUNS[rank]
    if quantize == "tiny":  # b is the device the programs are traced on
        cfg = deer_tiny()
        params = init_deer(cfg, seed=SEED, device="cpu")
        kw = dict(platforms=("cpu", "gpu"), device=b)
    else:
        cfg = export_config()
        params = init_deer(cfg, seed=SEED, device="cuda")
        kw = dict(batch_size=b, platforms=("gpu",), quantize=quantize)
    t0 = time.perf_counter()
    programs, meta = export_policy(params, cfg, **kw)
    t1 = time.perf_counter()
    save_exported(export_path(root, rank), programs, meta)
    return {"export_seconds": t1 - t0,
            "save_seconds": time.perf_counter() - t1,
            "program_nodes": sum(len(ep.graph.nodes)
                                 for ep in programs.values())}


def same_carry(torch, a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def served_pair(torch, np, cfg, live, aot, b: int, seed: int) -> dict:
    """EXPORT_STEPS steps of ``aot`` (the artifact) and ``live`` at B=``b``
    from a reset, each step's threshold row the sweep's: exits equal,
    actions, carries and last hidden states bit-equal.  Each side's host
    ms and K1-K4 launches."""
    counters = kernel_counters()
    n_exits = len(live.exits)
    live.reset(), aot.reset()
    out = {"exit_layers": [], "step_ms": [], "live_step_ms": [],
           "launches": dict.fromkeys(counters, 0),
           "live_launches": dict.fromkeys(counters, 0)}
    for s in range(EXPORT_STEPS):
        th = [SWEEP[s]] * n_exits
        live.set_thresholds(th), aot.set_thresholds(th)
        args = make_policy_inputs(np, cfg, b, seed + s)
        got = {}
        for side, pol in (("", aot), ("live_", live)):
            for f in counters.values():
                f.launches = 0
            t0 = time.perf_counter()
            if b == 1:
                got[side] = (pol.step(*args), [pol.last_exit_layer])
            else:
                acts, exits = pol.step_batch(*args)
                got[side] = (acts, exits.tolist())
            out[side + "step_ms"].append((time.perf_counter() - t0) * 1e3)
            for name, f in counters.items():
                out[side + "launches"][name] += f.launches
        check(got[""][1] == got["live_"][1]
              and np.array_equal(got[""][0], got["live_"][0])
              and same_carry(torch, aot.carry, live.carry)
              and torch.equal(aot.last_hidden, live.last_hidden),
              f"artifact B={b} step {s}: exits {got[''][1]} against the "
              f"live engine's {got['live_'][1]}, or actions / carry differ")
        out["exit_layers"].append(got[""][1])
    out["b"] = b
    out["median_ms"] = statistics.median(out["step_ms"])
    out["live_median_ms"] = statistics.median(out["live_step_ms"])
    return out


def cross_device_tiny(torch, np, root: str, checked: set) -> dict:
    """deer_tiny traced on the CPU loads onto the card (its programs moved
    by ``move_to_device_pass``) and takes the exits of the same artifact
    traced on the card, over a threshold sweep; its K2 shapes (fp32, tiny)
    are held against the plain version and join ``checked``."""
    from deer_vla_tpu_torch.core.config import deer_tiny
    from deer_vla_tpu_torch.models.flamingo import init_deer
    from deer_vla_tpu_torch.ops.kernels.indexed_matmul import (
        indexed_matmul, indexed_matmul_reference)
    from deer_vla_tpu_torch.serving.export import ExportedScanPolicy
    cfg = deer_tiny()
    params = init_deer(cfg, seed=SEED, device="cpu")
    pols = {where: ExportedScanPolicy(export_path(root, rank), params, cfg)
            for rank, (kind, where) in enumerate(EXPORT_RUNS)
            if kind == "tiny"}
    seen = set()
    exits, err = {"cpu": [], "cuda": []}, 0.0
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    with k2_calls(seen):
        for s, th in enumerate(([1e8, 1e8], [-1e8, 1e8], [1e-3, 1e8],
                                [1e-2, 1e8])):
            args = make_policy_inputs(np, cfg, 1, 900 + s)
            acts = {}
            for where, pol in pols.items():
                pol.set_thresholds(th)
                acts[where] = pol.step(*args)
                exits[where].append(pol.last_exit_layer)
            err = max(err, float(np.abs(acts["cpu"] - acts["cuda"]).max()))
    launches = {name: f.launches for name, f in counters.items()}
    check(exits["cpu"] == exits["cuda"] and len(set(exits["cuda"])) > 1,
          f"deer_tiny traced on the CPU took exits {exits['cpu']} on the "
          f"card, the card's trace {exits['cuda']}")
    rows = []
    idxs = [torch.tensor(i, dtype=torch.int32, device="cuda")
            for i in range(12)]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    for kernel, m, kk, n, dts in sorted(seen):
        check(kernel == "indexed_matmul", f"deer_tiny ran {kernel}")
        dt = getattr(torch, dts)
        x = torch.randn(m, kk, generator=gen, device="cuda").to(dt)
        w = (torch.randn(12, kk, n, generator=gen, device="cuda")
             * kk ** -0.5).to(dt)
        rows.append(indexed_case(
            torch, kernel, f"deer_tiny_{m}x{kk}x{n}_{dts}", x, n,
            (kk * n + m * kk + m * n) * x.element_size(),
            lambda i: indexed_matmul(x, w, i),
            lambda i: indexed_matmul_reference(x, w, i),
            lambda i: x @ w[i], idxs, checked))
    return {"exit_layers": exits["cuda"], "cpu_traced_max_abs_diff": err,
            "launches": launches, "k2_cases": rows}


def phase_export_3b(torch, np, cfg, params) -> dict:
    """The serving artifact: each mode of deer_3b at B=1 and B=8 at
    EXPORT_VIT_DEPTH ViT and EXPORT_DEPTH decoder layers, full width,
    traced and saved by a child process each (``child_export``, all at
    once), then loaded here (``ExportedScanPolicy``) against the serve
    phase's draw cut to that depth (its cross-attention gates drawn, so
    the exits differ by step) and served EXPORT_STEPS steps against the
    live ``ScanDeerPolicy(indexed_mm=True)`` on the same inputs
    (``served_pair``), every K1-K4 call of the artifact recorded; the int4
    B=1 artifact also as a bundle (the live engine's packed trees written
    beside it) through ``BundledScanPolicy``; deer_tiny traced on the CPU
    served on the card (``cross_device_tiny``).  All of it under a
    temporary directory, deleted after."""
    import tempfile

    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    from deer_vla_tpu_torch.ops.quant import tree_bytes
    from deer_vla_tpu_torch.serving.export import (BundledScanPolicy,
                                                   ExportedScanPolicy,
                                                   artifact_bytes,
                                                   save_weights)
    t_phase = time.perf_counter()
    ecfg = export_config()
    eparams = first_layers(params, ecfg)
    k1_seen, k2_seen, checked = set(), set(), set()
    runs, tmp = [], tempfile.mkdtemp(prefix="chip_smoke_export_")
    try:
        t0 = time.perf_counter()
        children = run_children("export", len(EXPORT_RUNS),
                                EXPORT_CHILD_TIMEOUT_S, store=tmp)
        children_s = time.perf_counter() - t0
        live = None
        for rank, (quantize, b) in enumerate(EXPORT_RUNS):
            if quantize == "tiny":
                continue
            mode = quantize or "bf16"
            if live is None or live.quantize != quantize:
                del live
                gc.collect()
                torch.cuda.empty_cache()
                live = ScanDeerPolicy(eparams, ecfg, indexed_mm=True,
                                      quantize=quantize)
            path = export_path(tmp, rank)
            t0 = time.perf_counter()
            aot = ExportedScanPolicy(path, eparams, ecfg, quantize=quantize)
            load_s = time.perf_counter() - t0
            with k1_calls(k1_seen), k2_calls(k2_seen):
                run = served_pair(torch, np, ecfg, live, aot, b, 800)
            run.update(children[rank], mode=mode, load_seconds=load_s,
                       artifact_bytes=artifact_bytes(path),
                       weight_bytes=tree_bytes(aot.params)
                       + tree_bytes(aot.stacked))
            every = {e for row in run["exit_layers"] for e in row}
            check(len(every) > 1, f"artifact {mode} B={b}: every step "
                                  f"exited at {every}")
            decoder = DECODER_KERNEL[quantize]
            check(run["launches"]["flash_attention"] > 0
                  and run["launches"][decoder] > 0
                  and run["launches"] == run["live_launches"],
                  f"artifact {mode} B={b}: launches {run['launches']} "
                  f"against the live engine's {run['live_launches']}")
            del aot
            if quantize == "int4" and b == 1:
                t0 = time.perf_counter()
                save_weights(path, live)
                write_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                bundled = BundledScanPolicy(path)
                bundle_load_s = time.perf_counter() - t0
                brun = served_pair(torch, np, ecfg, live, bundled, b, 870)
                run["bundle"] = {
                    "write_seconds": write_s, "load_seconds": bundle_load_s,
                    "weights_file_bytes":
                        Path(path + ".weights").stat().st_size,
                    "exit_layers": brun["exit_layers"],
                    "step_ms": brun["step_ms"],
                    "median_ms": brun["median_ms"],
                    "launches": brun["launches"]}
                del bundled
            runs.append(run)
        del live
        gc.collect()
        torch.cuda.empty_cache()
        tiny = cross_device_tiny(torch, np, tmp, checked)
        tiny["children"] = [c for c, (kind, _) in zip(children, EXPORT_RUNS)
                            if kind == "tiny"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"phase": "export_3b", "config": "deer_3b",
           "depth": {"vit": EXPORT_VIT_DEPTH, "decoder": EXPORT_DEPTH},
           "children_seconds": children_s,
           "artifacts": runs, "deer_tiny_cpu_to_card": tiny,
           "k1_keys": sorted(map(str, k1_seen)),
           "k2_keys": sorted(map(str, k2_seen)),
           "seconds": time.perf_counter() - t_phase,
           "launches": {name: sum(r["launches"][name] for r in runs)
                        for name in runs[0]["launches"]}}
    emit(out)
    out["k2_checked"] = checked
    return out


def drive_tooling(torch, np, cfg) -> list:
    """The tooling phases, on the training phase's checkpoints (before
    they are deleted): convert_3b, bayes_opt_3b, eval_ckpts, then
    profiling on the search's engine."""
    from deer_vla_tpu_torch.core.config import deer_3b
    t0 = time.perf_counter()
    results = [phase_convert_3b(torch, np, deer_3b(max_layer=CONVERT_DEPTH))]
    bo, policy = phase_bayes_opt_3b(torch, np)
    results += [bo, phase_eval_ckpts(torch, np),
                phase_profiling(torch, np, policy)]
    del policy
    torch.cuda.empty_cache()
    emit({"phase": "tooling", "seconds": time.perf_counter() - t0})
    return results

def drive_deployment(torch, np, cfg, params, calib) -> list:
    """The deployment phases on the seeded deer_3b draw: serve_http in bf16
    (K1 and K2) and int8 (K3 in K2's place), serve_http_batched on the
    bf16 engine, serve_http_variants."""
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    tok, scfg = serving_tokenizer(cfg)
    exits = list(scfg.all_exit_ids())
    profiles = threshold_profiles(calib, exits)
    t0 = time.perf_counter()
    pol = ScanDeerPolicy(params, scfg, indexed_mm=True)
    results = [phase_serve_http(torch, np, scfg, profiles, pol, tok),
               phase_serve_http_batched(torch, np, pol, tok, profiles)]
    del pol
    torch.cuda.empty_cache()
    pol = ScanDeerPolicy(params, scfg, indexed_mm=True, quantize="int8")
    results.append(phase_serve_http(torch, np, scfg, profiles, pol, tok,
                                    quantize="int8"))
    del pol
    torch.cuda.empty_cache()
    results += phase_serve_http_variants(torch, np, cfg, params, profiles)
    emit({"phase": "deployment", "seconds": time.perf_counter() - t0})
    return results


# fused_3b: the cond-chain oracle (eval/fused_policy.py) against the scan
# engine at B=1 on the serve phases' weights and inputs, 8 steps a row
FUSED_STEPS = 8
# data-dependent row: rounds of placing each threshold halfway (in log)
# across the widest gap between neighbouring deltas the last run measured
# at its exit, until the exits stop changing
FUSED_ROW_ROUNDS = 4


def fused_row(np, deltas: list, row: list) -> list:
    """Each non-last exit's threshold at the geometric midpoint of the
    widest gap between neighbouring deltas measured there (``deltas``: a
    step's per-bucket deltas, +inf where skipped); an exit with fewer than
    two keeps its threshold."""
    out = list(row)
    for k in range(len(row) - 1):
        d = np.sort([x[k] for x in deltas if np.isfinite(x[k])])
        if d.size < 2:
            continue
        gaps = np.log(d[1:]) - np.log(d[:-1])
        j = int(np.argmax(gaps))
        out[k] = float(np.sqrt(d[j] * d[j + 1]))
    return out


def phase_fused_3b(torch, np, cfg, params, scan, k1_checked: set) -> dict:
    """``FusedDeerPolicy`` (the cond-chain oracle: batch-wide exit, decoder
    through ``linear``) at deer_3b's full width and depth on the serve
    phases' weights and B=1 inputs, ``FUSED_STEPS`` steps under three
    rows: all 1e8 (the first exit), all -1 (the last), and a
    data-dependent one placed between measured deltas (``fused_row``), so
    that the bf16 rounding by which the two engines' decoders differ (K2
    in ``scan``, cuBLAS here) cannot decide an exit.  At every step the
    exit must equal ``scan``'s (ScanDeerPolicy, the carry threaded alike)
    and the actions agree within CROSS_TOL_BF16.  The kernel counts are
    set to 0 before and read after: K1 must run (the ViT), K2-K4 not; every
    K1 shape must be one the kernel phase checked."""
    from deer_vla_tpu_torch.eval.fused_policy import FusedDeerPolicy
    t0 = time.perf_counter()
    fused = FusedDeerPolicy(params, cfg)
    n = len(fused.exits)
    inputs = [make_policy_inputs(np, cfg, 1, 100 + s)
              for s in range(FUSED_STEPS)]
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    seen = set()

    def run_fused(row):
        fused.reset()
        fused.set_thresholds(row)
        out = {"exits": [], "acts": [], "ms": [], "deltas": []}
        for s, args in enumerate(inputs):
            fused.set_timestep(s)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            act = fused.step(*args)
            out["ms"].append((time.perf_counter() - t1) * 1e3)
            check(act.shape == (7,) and bool(np.isfinite(act).all()),
                  f"fused_3b step {s}: action {act}")
            out["exits"].append(fused.last_exit_layer)
            out["acts"].append(act)
            out["deltas"].append(fused.last_deltas.copy())
        return out

    with k1_calls(seen):
        runs = {"first": run_fused([1e8] * n), "last": run_fused([-1.0] * n)}
        row = fused_row(np, runs["last"]["deltas"], [1e8] * n)
        for _ in range(FUSED_ROW_ROUNDS):
            runs["data"] = run_fused(row)
            new = fused_row(np, runs["data"]["deltas"], row)
            if new == row:
                break
            row = new
        else:
            runs["data"] = run_fused(row)
        rows = {"first": [1e8] * n, "last": [-1.0] * n, "data": row}
    launches = {name: f.launches for name, f in counters.items()}
    check(launches["flash_attention"] > 0
          and all(launches[k] == 0 for k in DECODER_KERNEL.values()),
          f"fused_3b: K1 must run and K2-K4 not: {launches}")
    unchecked = seen - k1_checked
    check(not unchecked, f"fused_3b: K1 ran at unchecked shapes {unchecked}")
    exits_first = set(runs["first"]["exits"])
    exits_last = set(runs["last"]["exits"])
    check(exits_first == {fused.exits[0]} and exits_last == {fused.exits[-1]},
          f"fused_3b: first / last rows exited at {exits_first} / "
          f"{exits_last}")
    check(len(set(runs["data"]["exits"])) > 1,
          f"fused_3b: the data-dependent row {row} exits all at "
          f"{runs['data']['exits']}")
    # the scan engine on the same rows, inputs and (threaded) carry
    report = {}
    for name, r in rows.items():
        scan.set_thresholds(r)
        scan.reset()
        scan_exits, err, ratio = [], 0.0, []
        for s, args in enumerate(inputs):
            scan.set_timestep(s)
            deltas = []
            with recorded_deltas(deltas):
                act = scan.step(*args)
            scan_exits.append(scan.last_exit_layer)
            err = max(err, float(np.abs(act - runs[name]["acts"][s]).max()))
            fd = runs[name]["deltas"][s]
            ratio += [float(d[0]) / float(fd[k]) for k, d in
                      enumerate(deltas) if np.isfinite(fd[k]) and fd[k] > 0]
        check(scan_exits == runs[name]["exits"],
              f"fused_3b {name}: exits {runs[name]['exits']}, "
              f"ScanDeerPolicy {scan_exits} (row {r})")
        check(err <= CROSS_TOL_BF16["arm_max_abs"],
              f"fused_3b {name}: actions differ by {err}")
        live = [(x[k], r[k]) for x in runs[name]["deltas"]
                for k in range(n - 1) if np.isfinite(x[k])]
        report[name] = {
            "row": r, "exit_layers": runs[name]["exits"],
            "step_ms": runs[name]["ms"],
            "median_step_ms": statistics.median(runs[name]["ms"]),
            "vs_scan_arm_max_abs": err,
            "scan_over_fused_delta": [min(ratio, default=None),
                                      max(ratio, default=None)],
            # the nearest delta to its threshold, as delta / threshold
            "nearest_delta_over_threshold": min(
                (float(d / t) for d, t in live if 0 < t < 1e7),
                key=lambda x: abs(np.log(x)), default=None)}
    out = {"phase": "fused_3b", "config": "deer_3b",
           "engine": "FusedDeerPolicy", "steps": FUSED_STEPS,
           "nvidia_smi": DEVICE["smi"],
           "seconds": time.perf_counter() - t0, "rows": report,
           "median_step_ms": statistics.median(
               ms for r in runs.values() for ms in r["ms"]),
           "tolerance": CROSS_TOL_BF16, "launches": launches,
           "k1_shapes": sorted(map(str, seen))}
    scan.reset()
    emit(out)
    return out


@contextlib.contextmanager
def dispatch_timings(rec: list, phase: str):
    """While open, each ``ScanDeerPolicy.dispatch_batch`` made during the
    ``phase_rollout`` of ``phase`` appends (its handle, the host's
    perf_counter when it was called and when it returned) to ``rec``, and
    each ``finish_batch`` of such a handle the seconds it waited."""
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    dispatch, finish = ScanDeerPolicy.dispatch_batch, ScanDeerPolicy.finish_batch
    live = {}

    def timed_dispatch(self, *args, **kw):
        t0 = time.perf_counter()
        handle = dispatch(self, *args, **kw)
        if ROLLOUT_PHASE.get("name") == phase:
            live[id(handle)] = {"handle": handle, "called": t0,
                                "returned": time.perf_counter()}
            rec.append(live[id(handle)])
        return handle

    def timed_finish(self, handle, *args, **kw):
        t0 = time.perf_counter()
        try:
            return finish(self, handle, *args, **kw)
        finally:
            r = live.pop(id(handle), None)
            if r is not None:
                r["finish_s"] = time.perf_counter() - t0

    ScanDeerPolicy.dispatch_batch = timed_dispatch
    ScanDeerPolicy.finish_batch = timed_finish
    try:
        yield rec
    finally:
        ScanDeerPolicy.dispatch_batch = dispatch
        ScanDeerPolicy.finish_batch = finish


def gil_on_host_read(torch) -> dict:
    """Whether ``bool`` of a CUDA tensor releases the GIL while it waits: a
    thread reads a flag queued behind ~0.5 s of ``torch.cuda._sleep`` while
    this thread counts loop turns until the read is done; the turns a
    second against those beside a thread in ``time.sleep`` (which releases
    the GIL) for the same loop."""
    import threading

    def turns_beside(wait) -> tuple:
        got = []
        reader = threading.Thread(target=lambda: got.append(wait()))
        n, t0 = 0, time.perf_counter()
        reader.start()
        while not got:
            n += 1
        seconds = time.perf_counter() - t0
        reader.join()
        return n / seconds, seconds, got[0]

    asleep, _, _ = turns_beside(lambda: time.sleep(0.3))
    torch.cuda._sleep(1_000_000_000)
    flag = torch.ones((), device="cuda") > 0
    reading, wait_s, value = turns_beside(lambda: bool(flag))
    check(value is True, f"host read: {value}")
    return {"wait_s": wait_s, "turns_per_s_beside_sleep": asleep,
            "turns_per_s_beside_read": reading, "share": reading / asleep}


def phase_pipeline(torch, dispatches: list, rollouts: dict) -> dict:
    """The asynchronous ``dispatch_batch`` in the pipelined rollout (its
    report was held equal to --lanes 4's): the median time for a dispatch
    to return, for ``finish_batch`` to wait and for the step on the
    worker; the share of dispatches that returned before their step's
    decode ended, which must be most; the rollout's seconds against the
    same lanes with --pipeline 1; and whether the host read that ends a
    segment releases the GIL (``gil_on_host_read``), which the overlap
    needs."""
    done = [r for r in dispatches if "finish_s" in r]
    check(len(done) > 0, "pipeline: no dispatch timed")
    early = [r["returned"] < r["handle"].ended for r in done]
    gil = gil_on_host_read(torch)
    out = {"phase": "pipeline", "rollout": "rollout_lanes4_pipeline2",
           "nvidia_smi": DEVICE["smi"], "dispatches": len(done),
           "dispatch_return_median_ms": statistics.median(
               1e3 * (r["returned"] - r["called"]) for r in done),
           "finish_wait_median_ms": statistics.median(
               1e3 * r["finish_s"] for r in done),
           "step_median_ms": statistics.median(
               1e3 * (r["handle"].ended - r["handle"].started)
               for r in done),
           "returned_before_decode_end": sum(early) / len(early),
           "rollout_seconds": {
               "pipeline2_env_workers2":
                   rollouts["rollout_lanes4_pipeline2"]["rollout_seconds"],
               "pipeline1": rollouts["rollout_lanes4"]["rollout_seconds"]},
           "gil_on_host_read": gil}
    emit(out)
    check(sum(early) > len(early) / 2,
          f"pipeline: dispatch_batch returned after its decode on "
          f"{len(early) - sum(early)} of {len(early)} dispatches")
    check(gil["share"] > 0.5, f"pipeline: the host read holds the GIL "
                              f"while it waits: {gil}")
    return out


def drive_paths(torch, np, cfg, k1_checked: set) -> tuple:
    """The main paths on seeded deer_3b weights: serving in every mode with
    its cross-checks, the serving variants (DeerPolicy, the caches,
    BatchedDeerPolicy, ToMe), the vision, state and window variants on the
    same draw (serve_variants, cross_check_variants, serve_folded,
    calibrate_variants), the head families (serve_heads,
    cross_check_heads, calibrate_heads), calibration with its cross-check,
    the deployment phases (the HTTP servers, per stream and batched, on
    the calibrated thresholds), the train step's cross-checks (frozen and
    trained ViT),
    the cli/eval rollouts (the head families' and --tcp_rel's too), then
    cli/train, cli/eval and cli/serve on its checkpoint, and the same for a
    vit_concat state model (train_variants) and for the diffusion and gpt
    heads (train_heads)."""
    from deer_vla_tpu_torch.bridge import to_torch
    from deer_vla_tpu_torch.eval.policy import DeerPolicy
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    from deer_vla_tpu_torch.models.value_net import ExitController
    t0 = time.perf_counter()
    params = build_weights(torch, cfg)
    pol = ScanDeerPolicy(params, cfg, indexed_mm=True)
    emit({"phase": "weights", "seconds": time.perf_counter() - t0,
          "seed": SEED, "exits": pol.exits})
    serve = phase_serve(torch, np, cfg, pol)
    quantized = phase_serve_quantized(torch, np, cfg, params,
                                      serve["stacked_bytes"])
    export = phase_export_3b(torch, np, cfg, params)
    cpu_params = to_torch(params, "cpu")
    phase_cross_check(torch, np, cfg, params, cpu_params, pol)
    deer = DeerPolicy(params, cfg, controller=ExitController(
        exit_id_list=list(cfg.all_exit_ids()), max_layer=cfg.n_layers))
    scan_plain = ScanDeerPolicy(params, cfg)  # cuBLAS products, no K2
    variants = [phase_serve_bucketed(torch, np, cfg, deer, scan_plain, serve),
                phase_caches(torch, np, cfg, pol, deer),
                phase_batched_bucketed(torch, np, cfg, params, scan_plain),
                phase_fused_3b(torch, np, cfg, params, pol, k1_checked)]
    del pol, deer, scan_plain
    torch.cuda.empty_cache()
    variants.append(phase_serve_tome(torch, np, cfg, params, cpu_params))
    torch.cuda.empty_cache()
    # the cross-checks against fp32 on the CPU past the main one run the
    # same draw cut to CROSS_DEPTH / CROSS_VIT_DEPTH layers (the CPU's fp32
    # step is most of their time)
    cfg_cut = cut_depth(cfg, CROSS_DEPTH, CROSS_VIT_DEPTH)
    params_cut = first_layers(params, cfg_cut)
    cpu_cut = first_layers(cpu_params, cfg_cut)
    phase_cross_check_quantized(torch, np, cfg_cut, params_cut, cpu_cut)
    variants += phase_serve_variants(torch, np, cfg, params, serve)
    phase_cross_check_variants(torch, np, cfg_cut, params_cut, cpu_cut)
    variants += phase_serve_folded(torch, np, cfg, params)
    variants.append(phase_calibrate_variants(torch, np, cfg, params))
    variants += phase_serve_heads(torch, np, cfg, params, serve)
    phase_cross_check_heads(torch, np, cfg_cut, params_cut, cpu_cut)
    variants.append(phase_calibrate_heads(torch, np, cfg, params))
    calib = phase_calibrate(torch, np, cfg, params)
    variants += drive_deployment(torch, np, cfg, params, calib)
    phase_calibrate_cross_check(torch, np, cfg, params, cpu_params)
    phase_train_cross_check(torch, np, params_cut, cpu_cut)
    del cpu_params, cpu_cut, params_cut
    phase_train_unfreeze_vit(torch, np)
    del params
    torch.cuda.empty_cache()
    dispatches = []
    with dispatch_timings(dispatches, "rollout_lanes4_pipeline2"):
        rollouts = {name: phase_rollout(torch, np, name, ROLLOUT_ARGV + flags)
                    for name, flags in ROLLOUT_RUNS + HEAD_ROLLOUTS}
    piped, plain = (rollouts["rollout_lanes4_pipeline2"]["report"],
                    rollouts["rollout_lanes4"]["report"])
    check(piped == plain, f"--pipeline 2 --env_workers 2 changed the "
                          f"report: {piped} against {plain}")
    phase_pipeline(torch, dispatches, rollouts)
    rollouts["rollout_tcp"] = phase_rollout_tcp(torch, np)
    paths = [export] + variants + list(rollouts.values()) + [
        phase_train(torch, np), phase_train_eval(torch, np),
        phase_serve_cli(torch, np)]
    paths += drive_tooling(torch, np, cfg)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    paths += phase_train_variants(torch, np)
    paths += phase_train_heads(torch, np)
    phase_calvin_data(np)
    paths += [phase_train_calvin(torch, np),
              phase_train_calvin_difws(torch, np),
              phase_calib_calvin(torch, np)]
    return serve, quantized, calib, paths


# ---------------------------------------------------------------------------
# the vision-language evaluation suite (ROADMAP M16a)
# ---------------------------------------------------------------------------

VL_BATCH = 8
VL_NEW_TOKENS = 10
# the two engines on the card in bf16: the same prefill (K1 at a buffer of
# 128 tokens or more), then recompute runs the whole buffer through K1 again
# a token where the cached engine attends one row on the plain path; their
# logits at the first two decoded positions are held to the bf16 step's
# cross tolerance (CROSS_TOL_BF16's hidden_rel_l2), relative L2 (the second
# position over the rows whose first tokens agree)
VL_ENGINE_REL_L2 = 5e-2
# 2-layer deer_3b and blip_base at full width, bf16 on the card against
# fp32 on the CPU on the same weights: relative L2 of the hidden state,
# the logits and the teacher-forced summed NLL (CROSS_TOL_BF16's)
VL_CROSS_REL_L2 = 5e-2
VL_CROSS_DEPTH = 2
VL_DIR = REPO / "build" / "chip_smoke_vl"
# a demo caption's words: two demos and the query make prompts of about 150
# tokens, so that the decoder's buffer reaches K1
VL_DEMO_WORDS = 64
VL_CLI_RUNS = (
    ("vl_eval_cli_blip_caption",
     ["--task", "caption", "--debug", "--eval_model", "blip", "--model",
      "base", "--num_samples", str(VL_BATCH)]),
    ("vl_eval_cli_flamingo_vqa_fewshot_rices",
     ["--task", "vqa", "--debug", "--model", "mpt_dolly_3b", "--fewshot",
      "--rices", "--shots", "2", "--num_samples", str(VL_BATCH)]))


def vl_words(np, n: int, seed: int) -> str:
    r = np.random.RandomState(seed)
    vocab = ("red", "block", "table", "robot", "arm", "drawer", "light",
             "blue", "slider", "green", "button", "left", "right", "top",
             "small", "large", "pink", "switch", "door", "cup")
    return " ".join(vocab[i] for i in r.randint(0, len(vocab), n))


def vl_images(np, n: int, hw: tuple, seed: int):
    return np.random.RandomState(seed).randint(0, 256, (n,) + hw + (3,),
                                               np.uint8)


def vl_fewshot(np, model, b: int, seed: int, shots: int = 2):
    """(prompts, vision): ``b`` rows of ``shots`` captioned demo images and
    a query image, the prompts through ``build_fewshot_prompt``, each row
    4 tokens shorter than the one before."""
    prompts = [model.build_fewshot_prompt(
        [model.get_caption_prompt(vl_words(np, VL_DEMO_WORDS - 2 * r,
                                           seed + 10 * r + s))
         for s in range(shots)], model.get_caption_prompt())
        for r in range(b)]
    imgs = vl_images(np, b * (shots + 1), (240, 320), seed)
    k = shots + 1
    vision = model.build_fewshot_vision(
        [list(imgs[r * k:r * k + shots]) for r in range(b)],
        [imgs[r * k + shots] for r in range(b)])
    return prompts, vision


def vl_generate(torch, model, engine: str, ids, mask, vision,
                n_new: int = VL_NEW_TOKENS) -> dict:
    """One greedy generation on ``engine`` after a warm-up call: its tokens,
    step logits, host-clock ms (the call ends in a host copy), peak memory
    and kernel launches; then one more under the profiler for the device's
    busy time."""
    from deer_vla_tpu_torch.eval.kv_decode import greedy_generate_cached
    from deer_vla_tpu_torch.eval.vl_eval import greedy_generate
    gen = greedy_generate_cached if engine == "kv_cache" else greedy_generate
    gen(model.params, model.cfg, vision, ids, mask, max_new_tokens=2)
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    t0 = time.perf_counter()
    out = gen(model.params, model.cfg, vision, ids, mask,
              max_new_tokens=n_new, logits_out=steps)
    ms = (time.perf_counter() - t0) * 1e3
    launches = {n: f.launches for n, f in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = profiled_launches(torch, lambda: gen(
        model.params, model.cfg, vision, ids, mask, max_new_tokens=n_new))
    return {"tokens": out, "steps": [s.float().cpu() for s in steps],
            "ms": ms, "ms_per_token": ms / n_new, "peak_mem_gb": peak,
            "launches": launches, "profile": prof,
            "busy_ms_per_token": prof["device_busy_ms"] / n_new,
            "idle_share": 1 - prof["device_busy_ms"]
            / prof["profiled_wall_ms"]}


def vl_summary(run: dict, b: int, s: int) -> dict:
    return {"batch": b, "prompt_tokens": s, "new_tokens": VL_NEW_TOKENS,
            **{k: run[k] for k in ("ms", "ms_per_token", "peak_mem_gb",
                                   "launches", "busy_ms_per_token",
                                   "idle_share", "profile")}}


def phase_vl_generate(torch, np, cfg) -> dict:
    """deer_3b (12 layers, d_model 2048, vocab 50,432; the gates drawn, as
    ``build_weights`` draws them) generates 10 tokens for B=8 through
    ``FlamingoEvalModel``'s prompts and the engines: short VQA prompts on
    the recompute engine (a buffer below K1's 128 rows: K1 runs in the ViT
    only), then 2-shot interleaved prompts of about 150 tokens (3 images a
    row) on both engines, compared on the card."""
    from deer_vla_tpu_torch.data.text import HashTokenizer
    from deer_vla_tpu_torch.eval.eval_models import FlamingoEvalModel
    from deer_vla_tpu_torch.ops.attention import KERNEL_MIN_SQ
    t0 = time.perf_counter()
    tok = HashTokenizer(vocab_size=cfg.mpt.vocab_size, max_length=cfg.text_len)
    cfg = dataclasses.replace(cfg, media_token_id=tok.media_token_id)
    model = FlamingoEvalModel(cfg, build_weights(torch, cfg), tok)
    prompts = [model.get_vqa_prompt(
        f"what is the {vl_words(np, 1 + i % 3, i)}?") for i in range(VL_BATCH)]
    ids, mask = model.encode_prompts(prompts)
    vision = model.preprocess(vl_images(np, VL_BATCH, (200, 200), SEED))
    short = vl_generate(torch, model, "recompute", ids, mask, vision)
    fs_prompts, fs_vision = vl_fewshot(np, model, VL_BATCH, SEED + 1)
    fs_ids, fs_mask = model.encode_prompts(fs_prompts, raw=True)
    check(fs_ids.shape[1] >= KERNEL_MIN_SQ,
          f"few-shot prompts of {fs_ids.shape[1]} tokens do not reach K1")
    runs = {e: vl_generate(torch, model, e, fs_ids, fs_mask, fs_vision)
            for e in ("kv_cache", "recompute")}
    rec, kv = runs["recompute"], runs["kv_cache"]
    first = rel_l2(np, kv["steps"][0], rec["steps"][0])
    agree0 = rec["tokens"][:, 0] == kv["tokens"][:, 0]
    second = (rel_l2(np, kv["steps"][1][agree0], rec["steps"][1][agree0])
              if agree0.any() else None)
    out = {"phase": "vl_generate_3b", "config": "deer_3b",
           "mpt": [cfg.n_layers, cfg.mpt.d_model, cfg.mpt.vocab_size],
           "short_recompute": vl_summary(short, VL_BATCH, ids.shape[1]),
           "fewshot": {e: vl_summary(r, VL_BATCH, fs_ids.shape[1])
                       for e, r in runs.items()},
           "engines_first_logits_rel_l2": first,
           "engines_second_logits_rel_l2": second,
           "rows_first_token_agree": int(agree0.sum()),
           "token_agreement": float((rec["tokens"] == kv["tokens"]).mean()),
           "tol_rel_l2": VL_ENGINE_REL_L2,
           "kv_speedup": rec["ms"] / kv["ms"],
           "seconds": time.perf_counter() - t0,
           "launches": {k: short["launches"][k] + rec["launches"][k]
                        + kv["launches"][k] for k in short["launches"]}}
    emit(out)
    for name, r in (("short", short), *runs.items()):
        check(r["launches"]["flash_attention"] > 0,
              f"vl_generate {name}: K1 did not launch: {r['launches']}")
        check(all(bool(torch.isfinite(s).all()) for s in r["steps"]),
              f"vl_generate {name}: non-finite logits")
    check(first <= VL_ENGINE_REL_L2 and (second is None
                                         or second <= VL_ENGINE_REL_L2),
          f"vl_generate: the engines' logits {first} / {second}")
    del model, vision, fs_vision, runs, rec, kv, short
    released_gb(torch)
    return out


def phase_vl_blip(torch, np) -> dict:
    """blip_base (ViT-B/16 at 384 px: 577 tokens through K1; a BERT-base
    decoder) in bf16 through ``BlipEvalModel``: captions of 10 tokens for 8
    synthetic 480 x 640 frames resized to 384 px, then a VQA answer scored
    against 8 candidates."""
    from deer_vla_tpu_torch.eval.eval_models import (BlipEvalModel,
                                                     make_blip_tokenizer)
    from deer_vla_tpu_torch.models.blip import blip_base, init_blip
    cfg = blip_base()
    t0 = time.perf_counter()
    model = BlipEvalModel(cfg, init_blip(cfg, seed=SEED, device="cuda"),
                          make_blip_tokenizer(cfg), torch.bfloat16)
    init_s = time.perf_counter() - t0
    images = vl_images(np, VL_BATCH, (480, 640), SEED + 2)
    prompts = [model.get_caption_prompt()] * VL_BATCH
    model.get_outputs(model.preprocess(images), prompts, 2)  # warm-up
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    vision = model.preprocess(images)
    texts = model.get_outputs(vision, prompts, VL_NEW_TOKENS)
    caption_ms = (time.perf_counter() - t1) * 1e3
    caption_launches = {n: f.launches for n, f in counters.items()}
    answers = vl_words(np, VL_BATCH, 5).split()
    t1 = time.perf_counter()
    scores = model.score_texts(vision[:1], answers,
                               prompt=model.get_vqa_prompt("what is it?"))
    score_ms = (time.perf_counter() - t1) * 1e3
    launches = {n: f.launches for n, f in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = profiled_launches(torch, lambda: model.get_outputs(
        vision, prompts, VL_NEW_TOKENS))
    out = {"phase": "vl_blip_base", "config": "blip_base",
           "vision": [cfg.vision.layers, cfg.vision.width,
                      cfg.vision.seq_len],
           "text": [cfg.text.layers, cfg.text.width, cfg.text.vocab_size],
           "compute": "bfloat16", "batch": VL_BATCH, "init_s": init_s,
           "caption_ms": caption_ms,
           "caption_ms_per_token": caption_ms / VL_NEW_TOKENS,
           "score_ms": score_ms, "n_candidates": len(answers),
           "captions": texts[:2], "scores": [float(s) for s in scores],
           "profile": prof,
           "busy_ms_per_token": prof["device_busy_ms"] / VL_NEW_TOKENS,
           "idle_share": 1 - prof["device_busy_ms"]
           / prof["profiled_wall_ms"],
           "caption_launches": caption_launches, "launches": launches,
           "peak_mem_gb": peak}
    emit(out)
    check(len(texts) == VL_BATCH and bool(np.isfinite(scores).all()),
          f"vl_blip_base: {texts[:2]} {scores}")
    # one vision pass for the captions and one for the scores, 12 layers
    check(caption_launches["flash_attention"] == cfg.vision.layers
          and launches["flash_attention"] == 2 * cfg.vision.layers,
          f"vl_blip_base: K1 launches {launches}")
    del model, vision
    released_gb(torch)
    return out


def vl_cli_run(torch, phase: str, main, argv: list) -> dict:
    """A VL CLI in-process on the card, the kernel counts set to 0 before
    and read after; its last stdout line must be its result JSON."""
    import io
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    seconds = time.perf_counter() - t0
    launches = {n: f.launches for n, f in counters.items()}
    text = buf.getvalue()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / f"{phase}.log").write_text(text)
    check(json.loads(text.strip().splitlines()[-1]) == result,
          f"{phase}: the last line is not the result: {text[-300:]}")
    check(launches["flash_attention"] > 0,
          f"{phase}: K1 not launched: {launches}")
    out = {"phase": phase, "argv": argv, "seconds": seconds,
           "result": result, "launches": launches}
    emit(out)
    released_gb(torch)
    return out


def phase_vl_eval_cli(torch) -> list:
    """``cli/vl_eval --debug``: captions with blip_base, 2-shot VQA with
    RICES demos on deer_3b; ``cli/cache_features --debug`` (blip_base)
    writes an index that ``cli/vl_eval --rices --cached_features``
    reads."""
    from deer_vla_tpu_torch.cli import cache_features, vl_eval
    runs = [vl_cli_run(torch, name, vl_eval.main, argv)
            for name, argv in VL_CLI_RUNS]
    VL_DIR.mkdir(parents=True, exist_ok=True)
    feats = str(VL_DIR / "feats.npz")
    blip = ["--eval_model", "blip", "--model", "base", "--debug",
            "--num_samples", str(VL_BATCH)]
    runs.append(vl_cli_run(torch, "vl_cache_features", cache_features.main,
                           ["--task", "caption", "--output", feats] + blip))
    runs.append(vl_cli_run(torch, "vl_eval_cli_cached_features",
                           vl_eval.main, ["--task", "caption", "--rices",
                                          "--cached_features", feats]
                           + blip))
    check(runs[-2]["result"]["n"] == VL_BATCH
          and len(runs[-1]["result"]["rices_example"]) == 2,
          f"vl_eval_cli: cached features {runs[-2:]}")
    shutil.rmtree(VL_DIR, ignore_errors=True)
    return runs


def vl_cross_inputs(np, tok, cfg, b: int = 2):
    """(ids, mask, target, vision) at deer_3b: 1-shot prompts (a buffer
    past K1's 128 rows on the card), ragged, the query's caption scored."""
    from deer_vla_tpu_torch.eval.vl_eval import continuation_target_mask
    head = [f"<image>A photo of {vl_words(np, VL_DEMO_WORDS + 40, 40 + r)}"
            "<|endofchunk|><image>A photo of" for r in range(b)]
    texts = [h + " " + vl_words(np, 24 - 6 * r, r)
             for r, h in enumerate(head)]
    ids, mask = tok.encode_raw(texts, 160)
    _, pmask = tok.encode_raw(head, 160)
    target = continuation_target_mask(mask, pmask, trailing_specials=1)
    hw = cfg.vit.image_size
    vision = np.random.RandomState(7).randn(b, 2, 1, 3, hw, hw).astype(
        np.float32)
    return ids, mask, target, vision


def phase_vl_cross_check(torch, np) -> dict:
    """2-layer deer_3b and 2-layer blip_base at full width: bf16 on the
    card against fp32 on the CPU, on the same weights (drawn on the card,
    copied): the decoder's last hidden state, the logits and the
    teacher-forced summed NLL, relative L2."""
    from deer_vla_tpu_torch.bridge import to_torch
    from deer_vla_tpu_torch.core.config import FP32, deer_3b
    from deer_vla_tpu_torch.data.text import HashTokenizer
    from deer_vla_tpu_torch.eval.vl_eval import summed_nll
    from deer_vla_tpu_torch.models import blip as tblip
    from deer_vla_tpu_torch.models.flamingo import encode_vision
    from deer_vla_tpu_torch.models.mpt import decoder_forward, lm_logits
    t0 = time.perf_counter()
    out = {"phase": "vl_cross_check", "depth": VL_CROSS_DEPTH,
           "tol_rel_l2": VL_CROSS_REL_L2}

    cfg = deer_3b(max_layer=VL_CROSS_DEPTH)
    tok = HashTokenizer(vocab_size=cfg.mpt.vocab_size)
    cfg = dataclasses.replace(cfg, media_token_id=tok.media_token_id)
    params = build_weights(torch, cfg)
    ids, mask, target, vision = vl_cross_inputs(np, tok, cfg)

    @torch.no_grad()
    def flamingo(p, c, dev):
        i, m, t = (torch.from_numpy(a.astype(np.int64)).to(dev)
                   for a in (ids, mask, target))
        media = encode_vision(p, torch.from_numpy(vision).to(dev), None, c)
        _, x = decoder_forward(p["decoder"], i, m, media, c)
        logits = lm_logits(p["decoder"], x, c.dtypes.cdt, arch=c.mpt.arch)
        nll = summed_nll(logits, i, t)
        valid = m.bool()
        return [a.float().cpu() for a in (x[valid], logits[valid], nll)]

    card = flamingo(params, cfg, "cuda")
    cpu_params = to_torch(params, "cpu")
    del params
    released_gb(torch)
    ref = flamingo(cpu_params, dataclasses.replace(cfg, dtypes=FP32), "cpu")
    del cpu_params
    out["deer_3b"] = {"buffer": ids.shape[1], "tokens": int(mask.sum()),
                      **{k: rel_l2(np, a, b) for k, a, b in zip(
                          ("hidden_rel_l2", "logits_rel_l2", "nll_rel_l2"),
                          card, ref)}}

    base = tblip.blip_base()
    bcfg = tblip.BlipConfig(
        vision=dataclasses.replace(base.vision, layers=VL_CROSS_DEPTH),
        text=dataclasses.replace(base.text, layers=VL_CROSS_DEPTH))
    bparams = tblip.init_blip(bcfg, seed=SEED, device="cuda")
    r = np.random.RandomState(8)
    pix = r.randn(2, 3, 384, 384).astype(np.float32)
    bids = r.randint(1000, 30000, (2, 24)).astype(np.int64)
    bids[:, 0] = bcfg.text.bos_token_id
    bmask = np.ones_like(bids)
    bmask[1, 18:] = 0
    btarget = (np.arange(24)[None] >= 6) & (bmask > 0)

    @torch.no_grad()
    def blip(p, dev, dt):
        i, m, t = (torch.from_numpy(a.astype(np.int64)).to(dev)
                   for a in (bids, bmask, btarget))
        enc = tblip.vision_forward(p, torch.from_numpy(pix).to(dev, dt),
                                   bcfg.vision)
        logits = tblip.text_decoder_forward(p, i, m, enc, bcfg.text)
        nll = summed_nll(logits, i, t)
        return [a.float().cpu() for a in (enc, logits[m.bool()], nll)]

    card = blip(bparams, "cuda", torch.bfloat16)
    ref = blip(to_torch(bparams, "cpu"), "cpu", torch.float32)
    del bparams
    out["blip_base"] = {k: rel_l2(np, a, b) for k, a, b in zip(
        ("vision_rel_l2", "logits_rel_l2", "nll_rel_l2"), card, ref)}
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    for model in ("deer_3b", "blip_base"):
        for k, v in out[model].items():
            if k.endswith("rel_l2"):
                check(v <= VL_CROSS_REL_L2,
                      f"vl_cross_check {model} {k} {v}")
    released_gb(torch)
    return out


def drive_vl(torch, np, cfg) -> list:
    """The VL phases (ROADMAP M16a): vl_generate_3b, vl_blip_base, the
    CLIs, then the cross-checks."""
    t0 = time.perf_counter()
    paths = [phase_vl_generate(torch, np, cfg), phase_vl_blip(torch, np)]
    paths += phase_vl_eval_cli(torch)
    phase_vl_cross_check(torch, np)
    emit({"phase": "vl", "seconds": time.perf_counter() - t0})
    return paths


def phase_k1_vl(torch, inputs: dict, checked: set) -> list:
    """K1 against its plain version at each call key of the VL and the
    pretraining phases that no earlier phase checked, on the first inputs
    the paths gave it
    (``inputs``, kept by ``k1_calls``: BLIP's
    577-token ViT, the decoder's buffers with their ALiBi + causal +
    padding bias, the cross-attention over 3 images' latents with its
    media mask), timed beside its plain version and SDPA.  The tolerance is
    K1_TOL times max(1, max |plain output|): these activations are not of
    unit scale."""
    from deer_vla_tpu_torch.ops.kernels.flash_attention import (
        flash_attention, flash_attention_reference)
    rows = []
    for key, (q, k, v, bias, scale) in sorted(inputs.items(),
                                              key=lambda kv: str(kv[0])):
        if key in checked:
            continue
        dt = str(q.dtype)[6:]
        got = flash_attention(q, k, v, bias, scale)
        ref = flash_attention_reference(q, k, v, bias, scale)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        tol = K1_TOL[dt] * max(1.0, ref.float().abs().max().item())
        check(bool(torch.isfinite(got).all()), f"K1 {key}: non-finite")
        check(err <= tol, f"K1 {key}: max abs err {err} > {tol}")
        b, h, sq, d = q.shape
        sk = k.shape[2]
        # q, k, v and the output once, the bias's own elements once
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        if bias is not None:
            nbytes += bias.numel() * bias.element_size()
        rows.append({
            "kernel": "flash_attention", "shape": list(q.shape), "sk": sk,
            "dtype": dt, "strided": not q.is_contiguous(),
            "bias": None if bias is None else list(bias.shape),
            "max_abs_err": err, "tolerance": tol,
            **bound(nbytes, 4 * b * h * sq * sk * d, dt),
            **(k1_times(torch, q, k, v, scale) if bias is None
               else k1_bias_times(torch, q, k, v, bias, scale))})
        checked.add(key)
    inputs.clear()
    emit({"phase": "k1_vl", "cases": rows})
    return rows


# the synthetic bf16 ViT call of K1's backward: split_heads views of one
# fused qkv, as a bf16 --unfreeze_vit run hands them over
K1_BWD_VIT = {"batch": 4, "heads": 16, "seq": 257, "head_dim": 64}


def k1_backward_vit_case(torch) -> tuple:
    """(q, k, v, None, out, dout, scale, stats) of the bf16 ViT call: q, k,
    v views of one seeded (B, S, 3 * H * D) qkv, the forward's output and
    statistics, a seeded upstream gradient."""
    from deer_vla_tpu_torch.ops.attention import split_heads
    from deer_vla_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_with_stats)
    b, h, s, d = (K1_BWD_VIT[n] for n in ("batch", "heads", "seq",
                                          "head_dim"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = (split_heads(x, h) for x in qkv.chunk(3, dim=-1))
    scale = d ** -0.5
    out, stats = flash_attention_with_stats(q, k, v, None, scale)
    dout = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    return q, k, v, None, out, dout, scale, stats


def stats_errors(stats, ref) -> dict:
    """The largest error of saved row statistics against the plain ones,
    each element relative to max(1, |plain m|) for m and to the plain 1 / l
    for 1 / l."""
    m, il = stats.float()
    rm, ril = ref.float()
    return {"m": ((m - rm).abs() / rm.abs().clamp(min=1)).max().item(),
            "inv_l": ((il - ril).abs() / ril.abs()).max().item()}


def phase_k1_backward(torch, inputs: dict) -> list:
    """K1's backward (``flash_attention_backward``) against its plain
    version at each call key the paths differentiated K1 at, on the last
    inputs they gave it (``inputs``, kept by ``k1_backward_calls`` with the
    statistics their forward saved) and at the synthetic bf16 ViT call
    (``k1_backward_vit_case``), each on its own upstream gradient and on a
    seeded one of unit scale (the path's own can be tiny): dq, dk and dv
    each within K1_TOL times max |plain gradient|, the plain version
    recomputing its statistics.  In bf16 also: the forward with statistics
    gives the output of the forward without, bit for bit; its statistics
    and those the path saved are within K1_TOL of the plain forward's
    (``stats_errors``); two launches of the backward give the same bits.
    Timed beside its plain version and SDPA's backward
    (``torch.autograd.grad`` through ``scaled_dot_product_attention`` on the
    same q, k, v, bias and upstream gradient, its forward outside the
    timing), each from CUDA events around eager calls; the kernel also from
    CUDA-graph replays.  The kernel is compared with SDPA eager against
    eager (``kernel_eager_ms`` with ``library_ms``)."""
    from deer_vla_tpu_torch.ops.kernels.flash_attention import (
        flash_attention, flash_attention_backward,
        flash_attention_backward_reference, flash_attention_reference,
        flash_attention_with_stats)
    F = torch.nn.functional
    check(bool(inputs), "k1_backward: no path ran K1's backward")
    vit = k1_backward_vit_case(torch)
    inputs[k1_key(vit[0], vit[1], None) + ("synthetic",)] = vit
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for key, (q, k, v, bias, out, dout, scale, stats) in sorted(
            inputs.items(), key=lambda kv: str(kv[0])):
        dt = str(q.dtype)[6:]
        check((stats is None) == (dt == "float32"),
              f"K1 backward {key}: the forward saved statistics "
              f"{None if stats is None else tuple(stats.shape)}")
        stats_err = None
        if stats is not None:
            plain_out, plain_stats = flash_attention_reference(
                q, k, v, bias, scale, with_stats=True)
            got_out, got_stats = flash_attention_with_stats(q, k, v, bias,
                                                            scale)
            check(torch.equal(got_out, flash_attention(q, k, v, bias, scale)),
                  f"K1 {key}: the forward with statistics changed its output")
            stats_err = {"forward": stats_errors(got_stats, plain_stats),
                         "path": stats_errors(stats, plain_stats)}
            check(all(e <= K1_TOL[dt] for d in stats_err.values()
                      for e in d.values()),
                  f"K1 {key}: row statistics off the plain ones: {stats_err}")
            del plain_out, got_out, got_stats
        unit = torch.randn(dout.shape, generator=gen, device="cuda").to(
            dout.dtype)
        errs, tols = {}, {}
        for tag, do in (("path", dout), ("unit", unit)):
            got = flash_attention_backward(q, k, v, bias, out, do, scale,
                                           stats)
            again = flash_attention_backward(q, k, v, bias, out, do, scale,
                                             stats)
            ref = flash_attention_backward_reference(q, k, v, bias, out, do,
                                                     scale)
            torch.cuda.synchronize()
            check(all(torch.equal(g, a) for g, a in zip(got, again)),
                  f"K1 backward {key}: two launches differ ({tag})")
            for name, g, r in zip(("dq", "dk", "dv"), got, ref):
                n = f"{tag}_{name}"
                errs[n] = (g.float() - r.float()).abs().max().item()
                tols[n] = K1_TOL[dt] * r.float().abs().max().item()
                check(bool(torch.isfinite(g).all()),
                      f"K1 backward {key}: {n} non-finite")
                check(errs[n] <= tols[n], f"K1 backward {key}: {n} max abs "
                      f"err {errs[n]} > {tols[n]}")
        b, h, sq, d = q.shape
        sk = k.shape[2]
        # q, k, v, out, dout read once, dq, dk, dv written once, the bias's
        # own elements and the saved statistics read once; the five
        # S x S x D products
        nbytes = (4 * q.numel() + 2 * k.numel() + 2 * v.numel()) \
            * q.element_size()
        if bias is not None:
            nbytes += bias.numel() * bias.element_size()
        if stats is not None:
            nbytes += stats.numel() * stats.element_size()
        qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))
        mask = None if bias is None else bias.to(q.dtype)
        with torch.enable_grad():
            lib_out = F.scaled_dot_product_attention(qq, kk, vv,
                                                     attn_mask=mask,
                                                     scale=scale)
        rows.append({
            "kernel": "flash_attention_backward", "shape": list(q.shape),
            "sk": sk, "dtype": dt, "strided": not q.is_contiguous(),
            "bias": None if bias is None else list(bias.shape),
            "synthetic": key[-1] == "synthetic",
            "max_abs_err": max(errs.values()), "max_abs_err_each": errs,
            "tolerance": tols, "stats_err": stats_err,
            **bound(nbytes, 10 * b * h * sq * sk * d, dt),
            "kernel_ms": graph_ms(torch, lambda: flash_attention_backward(
                q, k, v, bias, out, dout, scale, stats), 8),
            "kernel_eager_ms": time_ms(torch, lambda: flash_attention_backward(
                q, k, v, bias, out, dout, scale, stats), 8),
            "reference_ms": time_ms(
                torch, lambda: flash_attention_backward_reference(
                    q, k, v, bias, out, dout, scale), 4),
            "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                lib_out, (qq, kk, vv), dout, retain_graph=True), 8)})
        del lib_out, qq, kk, vv
    inputs.clear()
    emit({"phase": "k1_backward", "cases": rows})
    return rows


# ---------------------------------------------------------------------------
# VL pretraining and co-training (ROADMAP M16b), data-parallel scale-out
# (M15)
# ---------------------------------------------------------------------------

PRETRAIN_DIR = REPO / "build" / "chip_smoke_pretrain"
# cli/pretrain --debug at deer_3b's preset 12 layers: LAION B=8 (8 ViT
# images a step) and MMC4 B=4 (4 x 6 image slots: 24 ViT images a step)
# at 224 px, taking turns, 4 steps; a warmup of 1 step.  MMC4's text at
# its default 256 tokens: from 128 query rows the decoder's self- and
# cross-attention take K1, and train through K1's backward
PRETRAIN_ARGV = ["--debug", "--model", "mpt_dolly_3b", "--max_layer", "12",
                 "--batch_size_laion", "8", "--batch_size_mmc4", "4",
                 "--max_tokens", "256", "--steps", "4", "--warmup_steps",
                 "1", "--logging_steps", "1", "--run_name",
                 str(PRETRAIN_DIR)]
PRETRAIN_IMAGES = {"laion": 8, "mmc4": 4 * 6}
# cli/train --debug --cotrain at deer_3b widths, 4 decoder layers: 2
# trajectories of W=12 (24 two-camera ViT streams) and 6 caption images a
# step from the LAION shard cli/pretrain --debug wrote (16 samples: the VL
# stream starts over after 2 batches); one joint epoch of the
# DebugBatcher's 4 batches
COTRAIN_DIR = REPO / "build" / "chip_smoke_cotrain"
COTRAIN_VL_BATCH = 6
COTRAIN_ARGV = ["--debug", "--model", "mpt_dolly_3b", "--max_layer", "4",
                "--cotrain", "--cotrain_laion_shards",
                str(PRETRAIN_DIR / "debug-laion-*.tar"), "--vl_batch_size",
                str(COTRAIN_VL_BATCH), "--batch_size_calvin", "2",
                "--num_joint_epochs", "1", "--num_exit_epochs", "0",
                "--joint_warmup_steps", "1", "--logging_steps", "1",
                "--from_scratch", "--run_name", str(COTRAIN_DIR)]
# lm_loss and its trainable gradients, bf16 on the card against fp32 on the
# CPU, 2-layer deer_3b at full width, 2 caption rows (2 ViT images): bf16
# keeps 8 bits of mantissa; the loss within 2e-2 relative, the trainable
# gradients together (one vector) within 5e-2 relative L2 (as the VL
# cross-check's activations)
PRETRAIN_CROSS_DEPTH = 2
PRETRAIN_CROSS_TOL = {"loss_rel": 2e-2, "grads_rel_l2": 5e-2}
# the two-rank phases: two processes on the one card over gloo (NCCL takes
# one rank a device); each child's log goes to chiprun_out/chip_smoke/
SCALE_DIR = REPO / "build" / "chip_smoke_scale_out"
SCALE_RANKS = 2
SCALE_CHILD_TIMEOUT_S = 300
# sharded serving: B=8 streams, 4 a rank, 4 bf16 steps and 1 int8 step with
# per-stream threshold rows (stream i at SWEEP[i]); the actions against the
# single-process step_batch on the same card within the serve cross-checks'
# bf16 tolerance
SCALE_SERVE_B = 8
SCALE_SERVE_STEPS = 4
# two-process cli/train --coordinator --debug: deer_3b widths, 2 decoder
# layers, 2 trajectories a rank (24 ViT streams), one joint epoch of 2
# steps; the first loss against one process over the 4 trajectories,
# within bf16 noise (as DIFWS_LOSS_REL)
SCALE_TRAIN_BATCH = 2


def scale_train_argv(batch: int, run: Path) -> list:
    return ["--debug", "--model", "mpt_dolly_3b", "--max_layer", "2",
            "--batch_size_calvin", str(batch), "--num_joint_epochs", "1",
            "--num_exit_epochs", "0", "--joint_warmup_steps", "1",
            "--logging_steps", "1", "--from_scratch", "--run_name",
            str(run)]


SCALE_TRAIN_STEPS = 2
SCALE_TRAIN_LOSS_REL = 1e-2


def reset_launches() -> dict:
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    return counters


def launches_of(counters: dict) -> dict:
    return {n: f.launches for n, f in counters.items()}


@contextlib.contextmanager
def timed_steps(module, name: str, times: list):
    """While open, ``module.name`` (a step builder) builds steps whose every
    call is timed, synchronised, into ``times``."""
    import torch
    real = getattr(module, name)

    def build(*a, **kw):
        step = real(*a, **kw)

        def timed(*sa, **skw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(*sa, **skw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            return out
        return timed

    setattr(module, name, build)
    try:
        yield times
    finally:
        setattr(module, name, real)


def phase_pretrain_3b(torch, np) -> dict:
    """``cli/pretrain --debug`` in-process on the card (``PRETRAIN_ARGV``):
    every loss finite; K1 24 times a step for the ViT and, on MMC4's 256
    tokens, once for each decoder layer's self-attention and each
    cross-attention, each of those differentiated by K1's backward (the
    ViT's calls are not); K2-K4 never; the frozen leaves bit for bit the
    seed's fresh draw, the trainable leaves with a gradient moved."""
    import io
    from deer_vla_tpu_torch.cli import pretrain as cli
    from deer_vla_tpu_torch.models.flamingo import init_deer, trainable_mask
    from deer_vla_tpu_torch.ops.layers import (flat_key,
                                               tree_leaves_with_path)
    from deer_vla_tpu_torch.train import pretrain
    from deer_vla_tpu_torch.train.optimizer import flat_leaves
    shutil.rmtree(PRETRAIN_DIR, ignore_errors=True)
    counters = reset_launches()
    held_gb = released_gb(torch)
    torch.cuda.reset_peak_memory_stats()
    times, buf = [], io.StringIO()
    t0 = time.perf_counter()
    with timed_steps(pretrain, "make_pretrain_step", times), \
            contextlib.redirect_stdout(buf):
        params, last = cli.main(PRETRAIN_ARGV)
    seconds = time.perf_counter() - t0
    launches = launches_of(counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "cli_pretrain.log").write_text(buf.getvalue())
    logs = [json.loads(x) for x in buf.getvalue().splitlines()
            if x.startswith('{"step"')]
    check(len(logs) == 4 and [d["source"] for d in logs]
          == ["laion", "mmc4"] * 2, f"pretrain_3b: steps {logs}")
    check(all(np.isfinite(d["lm_loss"]) for d in logs),
          f"pretrain_3b: losses {[d['lm_loss'] for d in logs]}")
    args = cli.build_parser().parse_args(PRETRAIN_ARGV)
    cfg = cli.model_config(args)
    # a decoder's attention calls a MMC4 step: its self-attention and its
    # cross-attention layers (all query 256 text rows)
    decoder_calls = cfg.mpt.n_layers + sum(
        x is not None for x in params["decoder"]["xattn"])
    check(launches["flash_attention"]
          == 4 * VIT_LAYERS + 2 * decoder_calls
          and launches["flash_attention_backward"] == 2 * decoder_calls,
          f"pretrain_3b: K1 launches {launches}, {decoder_calls} decoder "
          "attention calls a MMC4 step")
    check(all(launches[n] == 0 for n in DECODER_KERNEL.values()),
          f"pretrain_3b: K2-K4 launched: {launches}")
    final = flat_leaves(params)
    with torch.no_grad():
        start = flat_leaves(init_deer(cfg, seed=args.seed, device="cuda"))
    mask = {flat_key(p): m for p, m in tree_leaves_with_path(
        trainable_mask(params, cfg, "joint"))}
    frozen_changed = [k for k, m in mask.items()
                      if not m and not torch.equal(final[k], start[k])]
    check(not frozen_changed, f"pretrain_3b: frozen leaves changed: "
                              f"{frozen_changed[:5]}")
    moved = sum(not torch.equal(final[k], start[k])
                for k, m in mask.items() if m)
    check(moved > 0, "pretrain_3b: no trainable leaf moved")
    out = {"phase": "pretrain_3b", "argv": PRETRAIN_ARGV,
           "images_a_step": PRETRAIN_IMAGES, "seconds": seconds,
           "losses": [d["lm_loss"] for d in logs],
           "sources": [d["source"] for d in logs],
           "grad_norm_last": last["grad_norm"],
           "step_s": times, "peak_memory_gb": peak_gb,
           "allocated_before_gb": held_gb,
           "trainable_leaves": sum(mask.values()),
           "trainable_moved": moved,
           "frozen_leaves": sum(not m for m in mask.values()),
           "launches": launches}
    emit(out)
    del params, final, start
    released_gb(torch)
    return out


def phase_cotrain_3b(torch, np) -> dict:
    """``cli/train --debug --cotrain`` on the LAION shard phase pretrain_3b
    wrote (``COTRAIN_ARGV``), built by the CLI and trained in-process
    without writing checkpoints: the LM loss, the CALVIN loss (the combined
    loss less ``vl_weight`` times the LM loss), K1 once for the two-camera
    CALVIN frames and once for the VL images a step, K2-K4 never."""
    import io
    from deer_vla_tpu_torch.cli import train as cli
    shutil.rmtree(COTRAIN_DIR, ignore_errors=True)
    counters = reset_launches()
    held_gb = released_gb(torch)
    torch.cuda.reset_peak_memory_stats()
    steps, buf = [], io.StringIO()
    t0 = time.perf_counter()
    with train_updates(steps), contextlib.redirect_stdout(buf):
        trainer, args = cli.build_trainer(COTRAIN_ARGV)
        trainer.tcfg.save_every_epoch = False
        trainer.train()
    seconds = time.perf_counter() - t0
    launches = launches_of(counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    (OUT_DIR / "cli_train_cotrain.log").write_text(buf.getvalue())
    logs = [json.loads(x) for x in buf.getvalue().splitlines()
            if x.startswith('{"epoch"') and '"step"' in x]
    check(len(logs) == len(steps) == 4, f"cotrain_3b: {len(logs)} steps")
    lm = [d["lm_loss"] for d in logs]
    calvin = [d["loss"] - args.vl_weight * d["lm_loss"] for d in logs]
    check(all(np.isfinite(lm + calvin)), f"cotrain_3b: {lm} {calvin}")
    check(launches["flash_attention"] == 2 * VIT_LAYERS * len(steps),
          f"cotrain_3b: K1 launched {launches['flash_attention']} times")
    check(all(launches[n] == 0 for n in DECODER_KERNEL.values()),
          f"cotrain_3b: K2-K4 launched: {launches}")
    secs = step_intervals(steps)
    out = {"phase": "cotrain_3b", "argv": COTRAIN_ARGV,
           "seconds": seconds, "lm_loss": lm, "calvin_loss": calvin,
           "lm_acc": [d["lm_acc"] for d in logs],
           "vit_streams_a_step": 2 * trainer.cfg.window_size,
           "vl_images_a_step": COTRAIN_VL_BATCH,
           "step_s": secs, "step_s_median": statistics.median(secs),
           "peak_memory_gb": peak_gb, "allocated_before_gb": held_gb,
           "launches": launches}
    emit(out)
    del trainer
    released_gb(torch)
    return out


def phase_pretrain_cross_check(torch, np) -> dict:
    """``lm_loss`` and the gradients of the joint phase's trainable leaves,
    bf16 on the card against fp32 on the CPU, on a 2-layer deer_3b at full
    width (the same weights, drawn on the card and copied) and 2 caption
    rows of 32 tokens with an answer mask (``PRETRAIN_CROSS_TOL``)."""
    from deer_vla_tpu_torch.bridge import to_torch
    from deer_vla_tpu_torch.core.config import FP32, deer_3b
    from deer_vla_tpu_torch.data.text import HashTokenizer
    from deer_vla_tpu_torch.models.flamingo import trainable_mask
    from deer_vla_tpu_torch.ops.layers import (flat_key,
                                               tree_leaves_with_path)
    from deer_vla_tpu_torch.train.optimizer import flat_leaves
    from deer_vla_tpu_torch.train.pretrain import lm_loss
    t0 = time.perf_counter()
    cfg = deer_3b(max_layer=PRETRAIN_CROSS_DEPTH)
    tok = HashTokenizer(vocab_size=cfg.mpt.vocab_size)
    cfg = dataclasses.replace(cfg, media_token_id=tok.media_token_id)
    params = build_weights(torch, cfg)
    keys = sorted(flat_key(p) for p, m in tree_leaves_with_path(
        trainable_mask(params, cfg, "joint")) if m)
    r = np.random.RandomState(9)
    hw, s = cfg.vit.image_size, 32
    image = r.randn(2, 1, 1, 3, hw, hw).astype(np.float32)
    ids = r.randint(1, tok.eoc_token_id, (2, s)).astype(np.int64)
    ids[:, 0] = tok.media_token_id
    mask = np.ones((2, s), np.int64)
    mask[1, 24:] = 0
    answer = (np.arange(s)[None] >= 8).astype(np.int64).repeat(2, 0)

    def run(p, c, dev):
        flat = flat_leaves(p)
        leaves = [flat[k] for k in keys]
        for leaf in leaves:
            leaf.requires_grad_(True)
        with torch.enable_grad():
            loss, m = lm_loss(p, c, *(torch.from_numpy(a).to(dev) for a in
                                       (image, ids, mask)),
                              loss_mask=torch.from_numpy(answer).to(dev))
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        for leaf in leaves:
            leaf.requires_grad_(False)
        vec = torch.cat([(torch.zeros_like(leaf) if g is None else g)
                         .float().reshape(-1).cpu()
                         for leaf, g in zip(leaves, gs)])
        return float(loss.detach()), int(m["tokens"]), vec

    card = run(params, cfg, "cuda")
    cpu_params = to_torch(params, "cpu")
    del params
    released_gb(torch)
    ref = run(cpu_params, dataclasses.replace(cfg, dtypes=FP32), "cpu")
    del cpu_params
    loss_rel = abs(card[0] - ref[0]) / abs(ref[0])
    grads_rel = float(torch.linalg.vector_norm((card[2] - ref[2]).double())
                      / torch.linalg.vector_norm(ref[2].double()))
    out = {"phase": "pretrain_cross_check", "depth": PRETRAIN_CROSS_DEPTH,
           "tol": PRETRAIN_CROSS_TOL, "loss_card": card[0],
           "loss_cpu": ref[0], "tokens": ref[1], "loss_rel": loss_rel,
           "trainable_leaves": len(keys), "grad_elements": ref[2].numel(),
           "grads_rel_l2": grads_rel,
           "grad_norm_card": float(card[2].norm()),
           "grad_norm_cpu": float(ref[2].norm()),
           "seconds": time.perf_counter() - t0}
    emit(out)
    check(card[1] == ref[1] > 0, f"pretrain_cross_check tokens {card[1]} "
                                 f"{ref[1]}")
    check(loss_rel <= PRETRAIN_CROSS_TOL["loss_rel"],
          f"pretrain_cross_check loss {card[0]} against {ref[0]}")
    check(grads_rel <= PRETRAIN_CROSS_TOL["grads_rel_l2"],
          f"pretrain_cross_check gradients rel L2 {grads_rel}")
    return out


def start_children(name: str, ranks: int = SCALE_RANKS, store: str = None,
                   env: dict = None) -> dict:
    """Starts ``ranks`` processes of this script (``--child name rank
    store``) on the card, joined through a file store (or given ``store``,
    a path they share), with ``env`` as their environment when given;
    ``wait_children`` collects them, ``stop_children`` ends any left."""
    if store is None:
        SCALE_DIR.mkdir(parents=True, exist_ok=True)
        store = SCALE_DIR / f"{name}.store"
        store.unlink(missing_ok=True)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for rank in range(ranks):
        log = open(OUT_DIR / f"{name}_rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), "--child", name,
             str(rank), str(store)], cwd=REPO, stdout=log,
            stderr=subprocess.STDOUT, text=True, env=env), log))
    return {"name": name, "procs": procs}


def stop_children(started: dict) -> None:
    for p, log in started["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()


def wait_children(started: dict,
                  timeout_s: float = SCALE_CHILD_TIMEOUT_S) -> list:
    """Each started child must exit 0 with a CHILD_RESULT line within
    ``timeout_s``; their results, in rank order."""
    name = started["name"]
    results = []
    try:
        for rank, (p, log) in enumerate(started["procs"]):
            try:
                code = p.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                code = "timeout"
            log.close()
            text = (OUT_DIR / f"{name}_rank{rank}.log").read_text()
            check(code == 0, f"{name} rank {rank} exited {code}: "
                             f"{text[-2000:]}")
            lines = [x for x in text.splitlines()
                     if x.startswith("CHILD_RESULT ")]
            check(len(lines) == 1, f"{name} rank {rank}: no result line")
            res = json.loads(lines[0][len("CHILD_RESULT "):])
            check(res.get("ok") is True, f"{name} rank {rank}: {res}")
            results.append(res)
    finally:
        stop_children(started)
    return results


def run_children(name: str, ranks: int = SCALE_RANKS,
                 timeout_s: float = SCALE_CHILD_TIMEOUT_S,
                 store: str = None, env: dict = None) -> list:
    """``start_children`` then ``wait_children``."""
    return wait_children(start_children(name, ranks, store, env), timeout_s)


def child_serve(torch, np) -> dict:
    """One rank of scale_out_serve: ``ShardedBatchedPolicy`` over a seeded
    deer_3b ``ScanDeerPolicy`` (K2, and K3 in int8), B=8 streams with
    per-stream threshold rows, then the single-process ``step_batch`` of
    the same streams on the same engine for reference."""
    from deer_vla_tpu_torch.core.config import deer_3b
    from deer_vla_tpu_torch.eval import sharded_serving
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    from deer_vla_tpu_torch.eval.sharded_serving import ShardedBatchedPolicy
    cfg = deer_3b()
    params = build_weights(torch, cfg)
    pols = {None: ScanDeerPolicy(params, cfg, indexed_mm=True),
            "int8": ScanDeerPolicy(params, cfg, indexed_mm=True,
                                   quantize="int8")}
    del params
    released_gb(torch)
    exits = pols[None].exits
    rows = [[SWEEP[i % len(SWEEP)]] * len(exits)
            for i in range(SCALE_SERVE_B)]
    inputs = [make_policy_inputs(np, cfg, SCALE_SERVE_B, seed=300 + t)
              for t in range(SCALE_SERVE_STEPS)]
    gather_s = []
    real_gather = sharded_serving.gather_objects

    def timed_gather(obj):
        t = time.perf_counter()
        out = real_gather(obj)
        gather_s.append(time.perf_counter() - t)
        return out

    out = {"launches": {}, "step_ms": {}, "exits": {}, "max_abs_diff": {}}
    k1, k2 = set(), set()
    for mode, n_steps in ((None, SCALE_SERVE_STEPS), ("int8", 1)):
        name = mode or "bf16"
        pol = pols[mode]
        sharded = ShardedBatchedPolicy(pol)
        sharded.set_thresholds_batch(rows)
        counters = reset_launches()
        got, ms = [], []
        sharded_serving.gather_objects = timed_gather
        try:
            with k1_calls(k1), k2_calls(k2):
                for t in range(n_steps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got.append(sharded.step_batch(*inputs[t]))
                    ms.append(1e3 * (time.perf_counter() - t0))
        finally:
            sharded_serving.gather_objects = real_gather
        out["launches"][name] = launches_of(counters)
        pol.reset()
        pol.set_thresholds_batch(rows)
        with k1_calls(k1), k2_calls(k2):
            want = [pol.step_batch(*inputs[t]) for t in range(n_steps)]
        out["step_ms"][name] = ms
        out["exits"][name] = [e.tolist() for _, e in got]
        out["max_abs_diff"][name] = max(
            float(np.abs(a - wa).max()) for (a, _), (wa, _) in zip(got, want))
        check(all(np.array_equal(e, we) for (_, e), (_, we)
                  in zip(got, want)),
              f"scale_out_serve {name}: exits {out['exits'][name]} against "
              f"{[e.tolist() for _, e in want]}")
        check(out["max_abs_diff"][name] <= CROSS_TOL_BF16["arm_max_abs"],
              f"scale_out_serve {name}: actions differ by "
              f"{out['max_abs_diff'][name]}")
        check(sharded.last_exit_layer == max(out["exits"][name][-1]),
              "scale_out_serve: last_exit_layer is not the global max")
    out["gather_ms"] = [1e3 * s for s in gather_s]
    out["k1"] = sorted(map(list_key, k1))
    out["k2"] = sorted(map(list, k2))
    return out


def list_key(key) -> list:
    """A ``k1_key`` as JSON lists."""
    return [list(key[0]), key[1], key[2], key[3],
            None if key[4] is None else list(key[4])]


def tuple_key(key) -> tuple:
    return (tuple(key[0]), key[1], key[2], key[3],
            None if key[4] is None else tuple(key[4]))


def trainable_digest(torch, trainer) -> str:
    """sha256 over the bytes of every trainable leaf of the joint phase, in
    key order."""
    import hashlib
    from deer_vla_tpu_torch.train.optimizer import flat_leaves
    flat = flat_leaves(trainer.params)
    h = hashlib.sha256()
    for k in sorted(trainer._phases["joint"][0].trainable_keys()):
        h.update(k.encode())
        h.update(flat[k].detach().contiguous().reshape(-1)
                 .view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def child_train(torch, np, rank: int, store: str) -> dict:
    """One rank of scale_out_train: ``cli/train --coordinator`` as the CLI
    builds it, 2 steps of its slice of the global batch; the all-reduce
    timed (synchronised) apart."""
    import io
    from deer_vla_tpu_torch.cli import train as cli
    real = torch.distributed.all_reduce
    reduce_s = []

    def timed_reduce(t, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(t, *a, **kw)
        torch.cuda.synchronize()
        reduce_s.append(time.perf_counter() - t0)
        return out

    from deer_vla_tpu_torch.train import trainer as trainer_module
    k1 = set()
    steps, times, buf = [], [], io.StringIO()
    counters = reset_launches()
    torch.distributed.all_reduce = timed_reduce
    try:
        with train_updates(steps), k1_calls(k1), \
                timed_steps(trainer_module, "make_train_step", times), \
                contextlib.redirect_stdout(buf):
            trainer, _ = cli.build_trainer(
                scale_train_argv(SCALE_TRAIN_BATCH, SCALE_DIR / "run")
                + ["--coordinator", "file://" + store, "--num_processes",
                   str(SCALE_RANKS), "--process_id", str(rank)])
            trainer.loader.num_batches = SCALE_TRAIN_STEPS
            trainer.train()
    finally:
        torch.distributed.all_reduce = real
    logs = [json.loads(x) for x in buf.getvalue().splitlines()
            if x.startswith('{"epoch"') and '"step"' in x]
    digest = trainable_digest(torch, trainer)
    from deer_vla_tpu_torch.parallel import multihost
    world = multihost.process_count()
    multihost.shutdown()
    return {"world": world, "local_losses": [s["loss"] for s in steps],
            "logged": logs, "digest": digest, "step_s": times,
            "allreduce_s": reduce_s,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches_of(counters),
            "k1": sorted(map(list_key, k1))}


def child_main(name: str, rank: int, store: str) -> int:
    """A child of the multi-process phases: joins the group (serving: here;
    training: through cli/train) or exports one artifact into the
    directory ``store`` (``child_export``), prints one CHILD_RESULT
    line."""
    import torch
    if not torch.cuda.is_available():
        return 1
    sys.path.insert(0, str(REPO))
    import numpy as np
    from deer_vla_tpu_torch.parallel import multihost
    if name == "scale_out_serve":
        multihost.initialize("file://" + store, SCALE_RANKS, rank,
                             device="cuda")
        res = child_serve(torch, np)
        multihost.shutdown()
    elif name == "tp":
        multihost.initialize("file://" + store, TP_RANKS, rank,
                             device="cuda")
        res = {"serve": child_tp_serve(torch, np, rank),
               "train": child_tp_train(torch, np, rank)}
        multihost.shutdown()
    elif name == "export":
        res = child_export(torch, rank, store)
    elif name == "compile_cache":
        res = child_compile_cache(torch, store)
    else:
        res = child_train(torch, np, rank, store)
    print("CHILD_RESULT " + json.dumps({"ok": True, "rank": rank, **res}),
          flush=True)
    return 0


def phase_scale_out_serve(torch, np, k1_seen: set, k2_seen: set) -> dict:
    """Two ranks on the one card over gloo, ``ShardedBatchedPolicy`` at
    B=8 (``child_serve``): every rank's merged exits equal the
    single-process step's, the ranks agree, the kernels ran."""
    t0 = time.perf_counter()
    res = run_children("scale_out_serve")
    for r in res[1:]:
        check(r["exits"] == res[0]["exits"], "scale_out_serve: the ranks' "
                                             "exits differ")
    launches = {}
    for r in res:
        for mode in r["launches"].values():
            for n, c in mode.items():
                launches[n] = launches.get(n, 0) + c
        k1_seen.update(tuple_key(k) for k in r["k1"])
        k2_seen.update(tuple(k) for k in r["k2"])
    for r in res:
        check(r["launches"]["bf16"]["indexed_matmul"] > 0
              and r["launches"]["int8"]["indexed_matmul_q8"] > 0
              and r["launches"]["int8"]["indexed_matmul"] == 0
              and r["launches"]["bf16"]["flash_attention"] > 0,
              f"scale_out_serve rank {r['rank']}: launches {r['launches']}")
    out = {"phase": "scale_out_serve", "ranks": SCALE_RANKS,
           "streams": SCALE_SERVE_B, "streams_a_rank":
               SCALE_SERVE_B // SCALE_RANKS,
           "seconds": time.perf_counter() - t0,
           "step_ms": {r["rank"]: r["step_ms"] for r in res},
           "gather_ms": {r["rank"]: r["gather_ms"] for r in res},
           "exits": res[0]["exits"],
           "max_abs_diff": {r["rank"]: r["max_abs_diff"] for r in res},
           "tol_arm_max_abs": CROSS_TOL_BF16["arm_max_abs"],
           "launches": launches,
           "launches_by_rank": {r["rank"]: r["launches"] for r in res}}
    emit(out)
    return out


def phase_scale_out_train(torch, np, k1_seen: set) -> dict:
    """Two-process ``cli/train --coordinator --debug`` on the one card
    (``child_train``): every trainable leaf bit-equal across the ranks
    after the epoch, rank 0 alone wrote the checkpoint, and the first
    step's loss is one process's over the same 4 trajectories (run here,
    in-process, without a checkpoint)."""
    import io
    from deer_vla_tpu_torch.cli import train as cli
    t0 = time.perf_counter()
    shutil.rmtree(SCALE_DIR / "run", ignore_errors=True)
    res = run_children("scale_out_train")
    files = sorted(f.name for f in (SCALE_DIR / "run").iterdir())
    check(files == ["deer_0.ckpt", "deer_0.json", "heartbeat.json"],
          f"scale_out_train: run dir holds {files}")
    check(all(r["world"] == SCALE_RANKS for r in res),
          "scale_out_train: not a group of two")
    check(len({r["digest"] for r in res}) == 1,
          "scale_out_train: the ranks' trainable leaves differ")
    losses = [d["loss"] for d in res[0]["logged"]]
    check(len(losses) == SCALE_TRAIN_STEPS and np.isfinite(losses).all()
          and all(len(r["step_s"]) == SCALE_TRAIN_STEPS for r in res),
          f"scale_out_train: losses {losses}")
    check(res[1]["logged"] == [], "scale_out_train: rank 1 logged")
    for r in res:
        k1_seen.update(tuple_key(k) for k in r["k1"])
    # one process over the 4 trajectories: the first step's loss
    steps, buf = [], io.StringIO()
    with train_updates(steps), contextlib.redirect_stdout(buf):
        trainer, _ = cli.build_trainer(scale_train_argv(
            SCALE_RANKS * SCALE_TRAIN_BATCH, SCALE_DIR / "one"))
        trainer.loader.num_batches = 1
        trainer.tcfg.save_every_epoch = False
        trainer.train()
    del trainer
    released_gb(torch)
    one = losses[0]
    want = steps[0]["loss"]
    rel = abs(one - want) / abs(want)
    # the second step's share: the first also builds the step and warms up
    share = [r["allreduce_s"][-1] / r["step_s"][-1] for r in res]
    out = {"phase": "scale_out_train", "ranks": SCALE_RANKS,
           "trajectories_a_rank": SCALE_TRAIN_BATCH,
           "argv": scale_train_argv(SCALE_TRAIN_BATCH, SCALE_DIR / "run"),
           "seconds": time.perf_counter() - t0, "losses": losses,
           "local_losses": {r["rank"]: r["local_losses"] for r in res},
           "first_loss_two_ranks": one, "first_loss_one_process": want,
           "first_loss_rel": rel, "tol_rel": SCALE_TRAIN_LOSS_REL,
           "step_s": {r["rank"]: r["step_s"] for r in res},
           "allreduce_s": {r["rank"]: r["allreduce_s"] for r in res},
           "allreduce_share_last_step": share,
           "peak_memory_gb": {r["rank"]: r["peak_memory_gb"] for r in res},
           "checkpoint_files": files,
           "launches": {n: sum(r["launches"][n] for r in res)
                        for n in res[0]["launches"]}}
    emit(out)
    check(rel <= SCALE_TRAIN_LOSS_REL, f"scale_out_train: first loss "
                                       f"{one} against {want}")
    shutil.rmtree(SCALE_DIR, ignore_errors=True)
    return out


def drive_scale_out(torch, np, k1_seen: set, k2_seen: set) -> list:
    """The VL pretraining and co-training phases (ROADMAP M16b) and the
    two-rank phases (M15)."""
    t0 = time.perf_counter()
    paths = [phase_pretrain_3b(torch, np), phase_cotrain_3b(torch, np)]
    phase_pretrain_cross_check(torch, np)
    shutil.rmtree(PRETRAIN_DIR, ignore_errors=True)
    shutil.rmtree(COTRAIN_DIR, ignore_errors=True)
    released_gb(torch)
    paths += [phase_scale_out_serve(torch, np, k1_seen, k2_seen),
              phase_scale_out_train(torch, np, k1_seen)]
    emit({"phase": "scale_out", "seconds": time.perf_counter() - t0})
    return paths


# ---------------------------------------------------------------------------
# weight placement (ROADMAP M15b): four ranks on the one card over gloo
# ---------------------------------------------------------------------------

TP_RANKS = 4
TP_DIR = REPO / "build" / "chip_smoke_tp"
TP_CHILD_TIMEOUT_S = 480
# tp_serve_9b: deer_9b at full width and depth, tp=4, in each mode; 3 B=1
# steps (targets the exits in turn) and 2 B=8 steps (targets rotating over
# the streams), the carry threaded
TP_SERVE_MODES = (None, "int8", "int4")
TP_SERVE_B1_STEPS = 3
TP_SERVE_B8_STEPS = 2
# a threshold sits this factor from the one-process run's delta, above it
# at the target exit and below it at the exits before: tp reorders the
# bf16 sums, and a delta at its threshold could flip an exit
TP_MARGIN = 2.0
# tp_train: fsdp=2 x tp=2 at deer_9b's width cut to 2 decoder layers (as
# tests/test_9b_sharded.py cuts it) and 8 ViT layers (the frozen ViT's
# shards are gathered through the host every step), W=2, one trajectory a
# data shard, fp32 (the tolerances are tests/test_torch_tensor_parallel.py's),
# 2 steps
TP_TRAIN_DEPTH = 2
TP_TRAIN_VIT_DEPTH = 8
TP_TRAIN_MESH = (1, 2, 2)
TP_TRAIN_BATCH = 2
TP_TRAIN_STEPS = 2
TP_TRAIN_LR = 1e-4
TP_TRAIN_TOL = {"loss_rel": 1e-5, "grad_norm_rel": 1e-4,
                "param_rel_l2": 1e-5, "update_rel_l2": 1e-4}


def tp_train_config():
    from deer_vla_tpu_torch.core.config import FP32, deer_9b
    return cut_depth(deer_9b(max_layer=TP_TRAIN_DEPTH, exit_interval=2,
                             window_size=CALIB_CROSS_WINDOW, dtypes=FP32),
                     TP_TRAIN_DEPTH, TP_TRAIN_VIT_DEPTH)


@contextlib.contextmanager
def recorded_deltas(out: list):
    """While open, every exit test's (B,) delta of the scan engine is
    appended to ``out``, on the host, in the order the tests run."""
    from deer_vla_tpu_torch.eval import scan_policy
    real = scan_policy.get_delta

    def logged(a, b, kind):
        d = real(a, b, kind)
        out.append(d.float().cpu().numpy())
        return d

    scan_policy.get_delta = logged
    try:
        yield out
    finally:
        scan_policy.get_delta = real


def full_depth_deltas(torch, np, pol, inputs, b: int):
    """(B, exits) deltas of a full-depth run of ``inputs`` from the
    engine's carry; the carry is left as it was."""
    from deer_vla_tpu_torch.ops.layers import tree_map
    saved = (None if pol.carry is None
             else tree_map(lambda t: t.clone(), pol.carry))
    pol.set_thresholds([-1.0] * (len(pol.exits) - 1) + [1e8])
    seen = []
    with recorded_deltas(seen):
        if b == 1:
            pol.step(*inputs)
        else:
            pol.step_batch(*inputs)
    pol.carry = saved
    return np.stack(seen, 1)


def target_row(deltas, target: int, exits: list) -> list:
    """Per-exit thresholds that take ``target``: a factor ``TP_MARGIN``
    below each earlier exit's delta, above the target's."""
    row = []
    for j, e in enumerate(exits):
        if e < target:
            row.append(float(deltas[j]) / TP_MARGIN)
        elif e == target and e != exits[-1]:
            row.append(float(deltas[j]) * TP_MARGIN)
        else:  # after the target, and the last exit (always taken)
            row.append(1e8)
    return row


def tp_serve_plan(np, cfg) -> list:
    """The steps of tp_serve_9b: (streams, input seed, target exit of each
    stream), the B=1 steps first."""
    exits = list(cfg.all_exit_ids())
    plan = [(1, 700 + s, [exits[s % len(exits)]])
            for s in range(TP_SERVE_B1_STEPS)]
    plan += [(8, 800 + s, [exits[(i + s) % len(exits)] for i in range(8)])
             for s in range(TP_SERVE_B8_STEPS)]
    return plan


def tp_serve_steps(torch, np, cfg, pol, rows_of) -> dict:
    """Runs ``tp_serve_plan`` on ``pol`` (carry threaded, reset before the
    B=1 and the B=8 steps): ``rows_of(j, pol, inputs, b)`` gives step j's
    per-stream threshold rows.  Actions, exits, step times and the ratio
    of each evaluated delta to its threshold (the nearest is the margin
    left)."""
    out = {"actions": [], "exits": [], "rows": [], "step_ms": [],
           "ratios": []}
    last_b = None
    for j, (b, seed, _) in enumerate(tp_serve_plan(np, cfg)):
        if b != last_b:
            pol.reset()
            last_b = b
        inputs = make_policy_inputs(np, cfg, b, seed)
        rows = rows_of(j, pol, inputs, b)
        pol.set_thresholds_batch(rows)
        seen = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recorded_deltas(seen):
            if b == 1:
                act = pol.step(*inputs)[None]
                ex = [pol.last_exit_layer]
            else:
                act, ex = pol.step_batch(*inputs)
                ex = ex.tolist()
        out["step_ms"].append(1e3 * (time.perf_counter() - t0))
        for k, d in enumerate(seen):
            th = np.asarray([r[k] for r in rows])
            live = th < 1e7
            out["ratios"] += (d[live] / th[live]).tolist()
        out["actions"].append(np.asarray(act, np.float64).tolist())
        out["exits"].append(list(ex))
        out["rows"].append(rows)
    return out


def tp_serve_reference(torch, np, cfg, params, pol_bf16) -> dict:
    """The one-process deer_9b engine on the plan, by mode: each step's
    rows set from its own full-depth deltas (``target_row``), and each
    stream must take its target."""
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    t0 = time.perf_counter()
    plan = tp_serve_plan(np, cfg)
    out = {}
    for mode in TP_SERVE_MODES:
        pol = (pol_bf16 if mode is None else
               ScanDeerPolicy(params, cfg, indexed_mm=True, quantize=mode))

        def rows_of(j, p, inputs, b):
            d = full_depth_deltas(torch, np, p, inputs, b)
            return [target_row(d[i], plan[j][2][i], list(p.exits))
                    for i in range(b)]

        res = tp_serve_steps(torch, np, cfg, pol, rows_of)
        check(res["exits"] == [t for _, _, t in plan],
              f"tp reference {mode}: exits {res['exits']} are not the "
              f"targets {[t for _, _, t in plan]}")
        out[mode or "bf16"] = res
        if mode is not None:
            del pol
            torch.cuda.empty_cache()
    pol_bf16.reset()
    emit({"phase": "tp_serve_9b_reference", "config": "deer_9b",
          "seconds": time.perf_counter() - t0,
          "exits": {m: r["exits"] for m, r in out.items()},
          "nearest_delta_over_threshold": {
              m: [max([x for x in r["ratios"] if x <= 1], default=None),
                  min([x for x in r["ratios"] if x > 1], default=None)]
              for m, r in out.items()}})
    return out


def child_tp_serve(torch, np, rank: int) -> dict:
    """One rank of tp_serve_9b: the whole deer_9b tree drawn in turns
    (one rank at a time holds it: draw, keep this rank's tp shards, free),
    then a tp=4 ``ScanDeerPolicy`` on the shards in each mode, replaying
    the reference's rows; the exit layers checked across the ranks every
    step (``check_tp_exits``)."""
    from deer_vla_tpu_torch.core.config import deer_9b
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    from deer_vla_tpu_torch.ops.quant import tree_bytes
    from deer_vla_tpu_torch.parallel.mesh import Mesh, axis_groups
    from deer_vla_tpu_torch.parallel.sharding import shard_params
    cfg = deer_9b()
    ref = json.loads((TP_DIR / "serve_rows.json").read_text())
    mesh = Mesh(1, 1, TP_RANKS)
    groups = axis_groups(mesh, rank)
    t0 = time.perf_counter()
    local = None
    for turn in range(TP_RANKS):
        if turn == rank:
            whole = build_weights(torch, cfg)
            local, _ = shard_params(whole, mesh, rank, fsdp=False, tp=True)
            del whole
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        torch.distributed.barrier()
    out = {"draw_s": time.perf_counter() - t0,
           "local_gb": tree_bytes(local) / 1e9, "modes": {}}
    k1, k2 = set(), set()
    for mode in TP_SERVE_MODES:
        name = mode or "bf16"
        t1 = time.perf_counter()
        pol = ScanDeerPolicy(local, cfg, indexed_mm=True, quantize=mode,
                             tp=groups["tp"], check_tp_exits=True)
        build_s = time.perf_counter() - t1
        counters = reset_launches()
        with k1_calls(k1), k2_calls(k2):
            res = tp_serve_steps(torch, np, cfg, pol,
                                 lambda j, p, i, b: ref[name][j])
        res["launches"] = launches_of(counters)
        res["build_s"] = build_s
        out["modes"][name] = res
        del pol
        torch.cuda.empty_cache()
    del local
    out["k1"] = sorted(map(list_key, k1))
    out["k2"] = sorted(map(list, k2))
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["seconds"] = time.perf_counter() - t0
    return out


def tp_train_inputs(torch, cfg):
    """The global batch (``TP_TRAIN_BATCH`` trajectories, no random shift)
    on the card and fixed layer draws."""
    from deer_vla_tpu_torch.train.trainer import TrainConfig, prepare_batch
    cfg, batches = calib_debug_batches(cfg, TP_TRAIN_BATCH, 1)
    batch = prepare_batch(batches[0], cfg, None,
                          TrainConfig(rgb_pad=0, gripper_pad=0),
                          torch.device("cuda"))
    exits = cfg.all_exit_ids()
    w = cfg.window_size
    draws = {"rand_layer_ids": torch.tensor(
                 [[exits[(i + r) % len(exits)] for i in range(w)]
                  for r in range(TP_TRAIN_BATCH)]),
             "switch_layer_ids": torch.full((TP_TRAIN_BATCH, w),
                                            exits[-1])}
    return cfg, batch, draws


def tp_train_setup(torch, cfg, params):
    from deer_vla_tpu_torch.models.flamingo import trainable_mask
    from deer_vla_tpu_torch.train.optimizer import make_optimizer
    return make_optimizer(params, cfg, phase="joint",
                          learning_rate=TP_TRAIN_LR, warmup_steps=0,
                          total_steps=TP_TRAIN_STEPS,
                          trainable=trainable_mask(params, cfg, "joint"))


def tp_train_reference(torch, np) -> dict:
    """One process's ``TP_TRAIN_STEPS`` steps over the global batch on the
    card: losses, grad norms, the trainable leaves before and after (kept
    on the card); the batch and draws written for the ranks."""
    from deer_vla_tpu_torch.train.optimizer import flat_leaves
    from deer_vla_tpu_torch.train.train_step import (init_train_state,
                                                     make_train_step)
    t0 = time.perf_counter()
    cfg = tp_train_config()
    params = build_weights(torch, cfg)
    cfg, batch, draws = tp_train_inputs(torch, cfg)
    opt = tp_train_setup(torch, cfg, params)
    keys = opt.trainable_keys()
    flat = flat_leaves(params)
    before = {k: flat[k].clone() for k in keys}
    state = init_train_state(params, opt)
    step = make_train_step(cfg, opt)
    losses, norms = [], []
    for _ in range(TP_TRAIN_STEPS):
        state, m = step(state, batch, draws=[draws])
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    after = {k: flat[k] for k in keys}
    TP_DIR.mkdir(parents=True, exist_ok=True)
    torch.save({"batch": {k: v.cpu() for k, v in batch.items()},
                "draws": draws, "media_token_id": cfg.media_token_id},
               TP_DIR / "train_inputs.pt")
    del params, state, opt, flat
    released_gb(torch)
    return {"losses": losses, "grad_norms": norms, "before": before,
            "after": after, "seconds": time.perf_counter() - t0}


def child_tp_train(torch, np, rank: int) -> dict:
    """One rank of tp_train: fsdp=2 x tp=2 over this rank's shards of the
    seeded tree (``shard_params``), its data shard of the global batch, the
    masters and Adam moments sharded (ZeRO-3); after the steps the tree
    gathered (``gather_params``): frozen leaves bit for bit the draw, and
    rank 0 writes the trained leaves for the parent's comparison."""
    from deer_vla_tpu_torch.models.flamingo import trainable_mask
    from deer_vla_tpu_torch.parallel.mesh import Mesh, axis_groups
    from deer_vla_tpu_torch.parallel.sharding import (Layout, gather_params,
                                                      placements_by_path,
                                                      shard_params)
    from deer_vla_tpu_torch.ops.layers import (flat_key,
                                               tree_leaves_with_path)
    from deer_vla_tpu_torch.train.optimizer import flat_leaves
    from deer_vla_tpu_torch.train.train_step import (init_train_state,
                                                     make_train_step)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = tp_train_config()
    whole = build_weights(torch, cfg)
    mesh = Mesh(*TP_TRAIN_MESH)
    groups = axis_groups(mesh, rank)
    local, specs = shard_params(whole, mesh, rank, fsdp=True, tp=True)
    layout = Layout(mesh, rank, specs, groups)
    inputs = torch.load(TP_DIR / "train_inputs.pt", weights_only=False)
    cfg = dataclasses.replace(cfg, media_token_id=inputs["media_token_id"])
    i, w = mesh.data_index(rank), cfg.window_size
    per_window = {"labels"}
    rows = {k: (v[i:i + 1] if k in per_window else v[i * w:(i + 1) * w])
            .cuda() for k, v in inputs["batch"].items()}
    draws = {k: v[i:i + 1] for k, v in inputs["draws"].items()}
    opt = tp_train_setup(torch, cfg, local)
    state = init_train_state(local, opt)
    step = make_train_step(cfg, opt, layout=layout)
    losses, norms, step_s = [], [], []
    for _ in range(TP_TRAIN_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state, rows, draws=[draws])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    full = flat_leaves(gather_params(state.params, specs, mesh, groups))
    start = flat_leaves(whole)
    mask = {flat_key(p): m for p, m in
            tree_leaves_with_path(trainable_mask(whole, cfg, "joint"))}
    frozen_same = all(torch.equal(full[k], start[k])
                      for k, m in mask.items() if not m)
    by_key = {flat_key(p): s for p, s in placements_by_path(specs).items()}
    split = [k for k in opt.trainable_keys()
             if "fsdp" in by_key[k] and "tp" in by_key[k]]
    quarter = all(state.opt_state["mu"][k].numel() * TP_RANKS
                  == start[k].numel()
                  and state.opt_state["nu"][k].numel() * TP_RANKS
                  == start[k].numel() for k in split)
    if rank == 0:
        torch.save({k: full[k].cpu() for k in opt.trainable_keys()},
                   TP_DIR / "trained.pt")
    return {"losses": losses, "grad_norms": norms, "step_s": step_s,
            "frozen_bit_unchanged": frozen_same,
            "frozen_leaves": sum(not m for m in mask.values()),
            "split_trainable_leaves": len(split),
            "moments_quarter": quarter,
            "split_leaves": sum(any(s) for s in by_key.values()),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "seconds": time.perf_counter() - t0}


def phase_tp(torch, np, serve_ref: dict, k1_seen: set,
             k2_seen: set) -> list:
    """Phases tp_serve_9b and tp_train: one spawn of ``TP_RANKS`` children
    sharing the card over gloo runs both (``child_tp_serve``, then
    ``child_tp_train``).  Four processes on one card: their times are a
    record, not a speed."""
    t0 = time.perf_counter()
    TP_DIR.mkdir(parents=True, exist_ok=True)
    (TP_DIR / "serve_rows.json").write_text(json.dumps(
        {m: r["rows"] for m, r in serve_ref.items()}))
    train_ref = tp_train_reference(torch, np)
    res = run_children("tp", TP_RANKS, TP_CHILD_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    for r in res:
        k1_seen.update(tuple_key(k) for k in r["serve"]["k1"])
        k2_seen.update(tuple(k) for k in r["serve"]["k2"])
    # tp_serve_9b
    out_serve = {"phase": "tp_serve_9b", "config": "deer_9b", "tp": TP_RANKS,
                 "ranks_on_one_card": TP_RANKS, "runs": {},
                 "tol_arm_max_abs": CROSS_TOL_BF16["arm_max_abs"],
                 "margin_factor": TP_MARGIN,
                 "draw_s": [r["serve"]["draw_s"] for r in res],
                 "local_fp32_gb": [r["serve"]["local_gb"] for r in res],
                 "peak_memory_gb": [r["serve"]["peak_memory_gb"]
                                    for r in res],
                 "seconds": [r["serve"]["seconds"] for r in res]}
    for name, want in serve_ref.items():
        got = [r["serve"]["modes"][name] for r in res]
        diff = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                   for g in got for a, b in zip(g["actions"],
                                                want["actions"]))
        ratios = [x for g in got for x in g["ratios"]]
        out_serve["runs"][name] = {
            "exits": got[0]["exits"], "reference_exits": want["exits"],
            "max_abs_diff": diff,
            "nearest_delta_over_threshold": [
                max([x for x in ratios if x <= 1], default=None),
                min([x for x in ratios if x > 1], default=None)],
            "step_ms": {i: g["step_ms"] for i, g in enumerate(got)},
            "reference_step_ms": want["step_ms"],
            "build_s": [g["build_s"] for g in got],
            "launches": {n: sum(g["launches"][n] for g in got)
                         for n in got[0]["launches"]},
            "launches_by_rank": [g["launches"] for g in got]}
        k = DECODER_KERNEL[None if name == "bf16" else name]
        for i, g in enumerate(got):
            check(g["exits"] == want["exits"],
                  f"tp_serve_9b {name} rank {i}: exits {g['exits']} against "
                  f"one process's {want['exits']}")
            check(g["launches"][k] > 0 and (name == "bf16" or
                                            g["launches"]["indexed_matmul"]
                                            == 0),
                  f"tp_serve_9b {name} rank {i}: launches {g['launches']}")
        check(diff <= CROSS_TOL_BF16["arm_max_abs"],
              f"tp_serve_9b {name}: actions differ by {diff}")
    emit(out_serve)
    # tp_train
    ranks = [r["train"] for r in res]
    trained = torch.load(TP_DIR / "trained.pt", map_location="cuda")
    worst = 0.0
    for k, want in train_ref["after"].items():
        err = float(torch.linalg.vector_norm((trained[k] - want).double()))
        bound = (TP_TRAIN_TOL["param_rel_l2"]
                 * float(torch.linalg.vector_norm(want.double()))
                 + TP_TRAIN_TOL["update_rel_l2"] * float(
                     torch.linalg.vector_norm(
                         (want - train_ref["before"][k]).double())))
        worst = max(worst, err / max(bound, 1e-30))
    loss_rel = abs(ranks[0]["losses"][0] - train_ref["losses"][0]) \
        / abs(train_ref["losses"][0])
    norm_rel = abs(ranks[0]["grad_norms"][0] - train_ref["grad_norms"][0]) \
        / train_ref["grad_norms"][0]
    out_train = {"phase": "tp_train", "config": "deer_9b fp32, "
                 f"{TP_TRAIN_DEPTH} layers, a {TP_TRAIN_VIT_DEPTH}-layer "
                 f"ViT, W={CALIB_CROSS_WINDOW}",
                 "mesh": dict(zip(("dp", "fsdp", "tp"), TP_TRAIN_MESH)),
                 "ranks_on_one_card": TP_RANKS,
                 "losses": [r["losses"] for r in ranks],
                 "grad_norms": [r["grad_norms"] for r in ranks],
                 "one_process_losses": train_ref["losses"],
                 "one_process_grad_norms": train_ref["grad_norms"],
                 "first_loss_rel": loss_rel, "first_grad_norm_rel": norm_rel,
                 "param_err_over_bound": worst, "tol": TP_TRAIN_TOL,
                 "trainable_leaves": len(trained),
                 "split_trainable_leaves": ranks[0]["split_trainable_leaves"],
                 "split_leaves": ranks[0]["split_leaves"],
                 "frozen_leaves": ranks[0]["frozen_leaves"],
                 "step_s": [r["step_s"] for r in ranks],
                 "peak_memory_gb": [r["peak_memory_gb"] for r in ranks],
                 "one_process_seconds": train_ref["seconds"],
                 "seconds": [r["seconds"] for r in ranks],
                 "spawn_total_s": spawn_s}
    emit(out_train)
    check(loss_rel <= TP_TRAIN_TOL["loss_rel"],
          f"tp_train: first loss {ranks[0]['losses'][0]} against "
          f"{train_ref['losses'][0]}")
    check(norm_rel <= TP_TRAIN_TOL["grad_norm_rel"],
          f"tp_train: grad_norm {ranks[0]['grad_norms'][0]} against "
          f"{train_ref['grad_norms'][0]}")
    check(worst <= 1.0, f"tp_train: updated leaves {worst} of the bound")
    for i, r in enumerate(ranks):
        check(r["losses"] == ranks[0]["losses"]
              and r["grad_norms"] == ranks[0]["grad_norms"],
              f"tp_train rank {i}: losses {r['losses']} differ")
        check(r["frozen_bit_unchanged"], f"tp_train rank {i}: a frozen "
                                         "leaf changed")
        check(r["moments_quarter"] and r["split_trainable_leaves"] > 0,
              f"tp_train rank {i}: moments are not a quarter of a split "
              "leaf")
    del trained, train_ref
    shutil.rmtree(TP_DIR, ignore_errors=True)
    released_gb(torch)
    return [out_serve, out_train]


def main() -> int:
    if sys.argv[1:2] == ["--child"]:
        return child_main(sys.argv[2], int(sys.argv[3]), sys.argv[4])
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "deer_vla_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the deer_vla_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    builder = start_build()
    import numpy as np

    from deer_vla_tpu_torch.core.config import deer_3b

    smi = phase_device(torch)
    tc = phase_build(builder)
    cache_child = start_compile_cache()
    try:
        cfg = deer_3b()
        summary = phase_kernels(torch, vit_batches(cfg))
        summary.update(phase_kernels_9b(torch, summary["k2_checked"]))
        phase_compile_cache(cache_child)
    finally:
        stop_children(cache_child)

    k1_seen, k2_seen, bwd_inputs = set(), set(), {}
    with k1_calls(k1_seen), k2_calls(k2_seen), \
            k1_backward_calls(bwd_inputs):
        serve, quantized, calib, paths = drive_paths(
            torch, np, cfg, summary["k1_checked"])
        paths_9b, path_launches, tp_ref = drive_9b(torch, np)
        paths += paths_9b + phase_tp(torch, np, tp_ref, k1_seen, k2_seen)
        del tp_ref
        paths += drive_llama(torch, np)
        vl_inputs = {}
        with k1_calls(k1_seen, keep=vl_inputs):
            paths += drive_vl(torch, np, cfg)
            paths += drive_scale_out(torch, np, k1_seen, k2_seen)
    export = next(r for r in paths if r["phase"] == "export_3b")
    summary["k2_checked"] |= export.pop("k2_checked")
    summary["k1_vl"] = phase_k1_vl(torch, vl_inputs, summary["k1_checked"])
    summary["k1_backward"] = phase_k1_backward(torch, bwd_inputs)
    unchecked = k1_seen - summary["k1_checked"]
    emit({"phase": "k1_shapes", "driven": sorted(map(str, k1_seen)),
          "unchecked": sorted(map(str, unchecked))})
    check(k1_seen and not unchecked,
          f"K1 ran at shapes no phase held against its plain version: "
          f"{unchecked}")
    unchecked = k2_seen - summary["k2_checked"]
    emit({"phase": "k2_shapes", "driven": sorted(map(str, k2_seen)),
          "unchecked": sorted(map(str, unchecked))})
    check(k2_seen and not unchecked,
          f"K2-K4 ran at shapes no phase held against its plain version: "
          f"{unchecked}")

    path_launches["calibrate"] = calibrate_launches(calib)
    for r in paths:  # the rollouts, the training and CALVIN phases, and
        # the 9B and llama serve and rollout phases
        if "launches" in r:
            path_launches[r["phase"]] = r["launches"]
        for name, run in r.get("runs", {}).items():
            path_launches[f"{r['phase']}_{name}"] = run["launches"]
        if "debug_launches" in r:
            path_launches[r["phase"] + "_debug"] = r["debug_launches"]
    launches = dict(serve["launches"])
    launches["indexed_matmul_q8"] = \
        quantized["int8"]["launches"]["indexed_matmul_q8"]
    launches["indexed_matmul_q4"] = \
        quantized["int4"]["launches"]["indexed_matmul_q4"]
    launches["flash_attention_backward"] = \
        path_launches["pretrain_3b"]["flash_attention_backward"]
    for name, phase in (("indexed_matmul", "serve_9b"),
                        ("indexed_matmul_q8", "serve_9b_int8"),
                        ("indexed_matmul_q4", "serve_9b_int4")):
        launches[name + "_9b"] = path_launches[phase][name]
    for name, mode in (("indexed_matmul", "bf16"),
                       ("indexed_matmul_q8", "int8"),
                       ("indexed_matmul_q4", "int4")):
        launches[name + "_9b_tp4"] = \
            path_launches[f"tp_serve_9b_{mode}"][name]
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit(kernels_line(summary, launches, tc, path_launches))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
