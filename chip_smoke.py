#!/usr/bin/env python3
"""Drives the PyTorch port's main path once on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each printed as it ends; any failure raises and exits non-zero
without the final `"ok": true` line:
  1. device  - requires CUDA; prints the card as nvidia-smi names it;
  2. build   - builds the CUDA kernels (attention, int8 conv, int8
               attention, row -> int8, GroupNorm and GroupNorm -> int8;
               nvcc, sm_90a) into build/torch_ext/ and compiles the Triton
               kernels;
  3. kernels - each kernel against its plain PyTorch version on the card at
               the shapes the paths give it (SD1.5 512², CFG batch 8 and
               4; SD3 1024², CFG batch 2, and its VAE; ragged tails), with
               the device time per call of the kernel, of the plain version
               and of the library call (`device_ms`: the union of the
               device intervals of back-to-back calls under torch.profiler,
               the wrapper's own launches included) and the kernel's
               single-call CUDA-event time (`wall_ms`, which also holds the
               host's part of the call). K9's prologue (K to int8):
               codes and scales bit-equal, and per head (K9p) one device
               launch per call and a second call bit-equal. Float
               kernels: max abs error against the plain version evaluated
               in fp32 on the same bf16 inputs (bounds 3e-2 attention, 2e-2
               norms, the bf16 bound of tests/test_ops.py; attention also
               within 2e-2 of its largest output, and the bound must be
               below the error of the plain version with one 32-key tile,
               the smallest the kernels use, left out), and the error
               against the plain version in bf16; K3 (GroupNorm, SiLU,
               ReLU or none) also one device launch per call and a second
               call bit-equal, and its statistics are K5's: on one fp32
               tensor K3's output lies within one code step of K5's
               dequantized codes. int8 epilogue kernels (GroupNorm,
               LayerNorm, GEGLU, tanh-GELU, row, AdaLN -> int8): scales
               within 1e-6 relative, codes at most 1 apart and at least
               99.9% equal, the share of equal codes printed, and a second
               call equal bit for bit (K5's sums cross blocks); K5, K6, K7,
               K10, K11 (also on the MMDiT's image and context slices of
               one packed (B, N_h + N_c, C) attention output, read in
               place) and K13 (also on the (B, 1, C) chunks of one
               (B, 1, 6C) bf16 projection the MMDiT passes as scale and
               shift) must issue one device launch per call, counted in a
               profiler trace.
               int8 conv, both variants: equal to the plain version bit
               for bit. K12 (AdaLN): its forward within 2e-2 and one
               device launch per call, its gradient through both kernels
               within 1e-4 of the plain version's, relative to its largest
               value, and its backward alone against the plain backward:
               each of dx, dscale and dshift within 1e-4 of its largest
               plain value in fp32, and in bf16 within one bf16 rounding
               (2^-8 of the largest value) more; one device launch per
               call and a second call bit-equal. The attention lab modes
               at the SD1.5 64² and SD3 joint shapes, with K1's bounds
               (the no-softmax mode's output is no average of V: its
               bound is relative);
  4. slice   - SD1.5 at full width (default configs, bf16, random weights
               from a seed) answers two 512² requests of batch 2 with 8 DDIM
               steps and CFG 9; checks the images, that every kernel of the
               path was launched during the requests, that request 1 again
               under the profiler launches K3's and K9p's kernels once per
               wrapper call and none of their parent designs' device
               functions (`one_launch_per_call`; so do the int8, sd3 and
               midas phases), that one CFG epsilon evaluation makes 88 K3
               calls, and one CFG epsilon
               evaluation (t=999) against the same call on the plain ops
               (relative L2 <= 5e-2 over the uncond and cond outputs; the
               guided epsilon no farther from an fp32 evaluation than the
               plain ops, x1.25); prints seconds per request and step;
  5. int8    - the same with the int8 W8A8 serving policy and the int8 VAE
               (`create(policy=int8_policy(), vae_int8=True)`): the same
               checks, the launches of the int8 path's kernels, the guided
               epsilon against an fp32-compute int8 evaluation, and its
               distance from the bf16 policy for information; then a
               pipeline built with `conv_variant="xshift"` (same weights)
               answers request 1 through K8's xshift kernel, bit-equal to
               the im2col pipeline's images, with both variants' seconds
               per step;
  6. serve   - the micro-batching GenerationServer (max_batch 4, flush
               50 ms, warmed) over the int8 pipeline of phase 5: a burst of
               eight 512² requests at 8 steps (four UniPC, two DPM-Solver++,
               one PLMS, one DDIM at eta 0.5; guidance 5-9, control scale
               0.5-1, a seed each); every image (512,512,3), finite, in
               [0,1]; fewer batches than requests, the UniPC four as one;
               each batch bit-equal to `pipe.generate` on the same stacked
               inputs; the int8 path's kernels launched; one UniPC request
               at batch 1 no farther from an fp32-compute evaluation than
               1.25x the plain ops; one request beside two sets of three
               strangers bit-equal under the bf16 policy (a bf16 twin with
               the same weights; the int8 policy's difference printed);
               seconds per request by sampler, requests/s;
  7. ckpt    - reference checkpoints into the port at full width, on files
               written under build/ckpt_smoke/ (git-ignored, deleted at the
               phase's end), each file's size and seconds to write and to
               load printed: phase 4's pipeline (SD1.5 bf16, 1.43 B
               parameters, random weights) exported by
               `export_ldm_checkpoint` to a `.ckpt`, loaded by
               `PromptDiffusionSD15.from_single_file` (every state-dict
               tensor equal to its source: dtype, strides, values), request
               1 with phase 4's x_T as `init_noise` bit-equal to phase 4's
               images; the same through a `.safetensors` file
               (`tools/safetensors_io.py`); a rank-4 peft LoRA on every
               attention projection of the UNet and CLIP fused into the
               loaded pipeline: at scale 0 the image bit-equal, at scale 1
               each fused weight within 1e-6 (relative to its largest
               value) of W + B.A computed in fp64 on the host and rounded
               as the fold rounds (fp32, then the weight's dtype), the
               image finite and not the base image; `serve.main --ckpt
               FILE --policy int8 --steps 8 --demo`, its four PNGs equal
               to `SD15Adapter.execute` of the same requests on a pipeline
               loaded from the file; the batch entry `generate.main`, whole
               (PIL decodes the data root), on a COCO-layout root of four
               512² images, writing four PNGs; an SD3 folder at full width
               and 2 MMDiT, 2 ControlNet and 2 T5 layers written from a
               random int8 pipeline by `export_sd3_folder`, loaded by
               `PromptDiffusionSD3.from_folder(..., t5=True)` (state dicts
               equal) and one 1024² request at 2 steps with T5 staged
               bit-equal to the source's with T5 in-graph; the launches of
               the path's kernels; then `[notebook]`:
               `run_prompt_diffusion.main` on the `.ckpt` at 512², 8 DDIM
               steps, with --task hed and --task seg on `.pth` files
               written from random HED and UniFormer modules (the PNG
               exists and is not constant);
     eval    - evaluation at full width, on files under build/eval_smoke/
               (git-ignored, deleted at the phase's end), with phase 4's
               pipeline: `utils.config.create_model` on a cldm_v15-format
               YAML written here (every state-dict name, shape and dtype
               equal to `create()`'s; with phase 4's weights request 1
               bit-equal to phase 4's); the FID InceptionV3 (random
               He-normal weights from a seed) on a batch of 64 at 512²:
               device ms and images/s, features finite and within 1e-4
               (relative L2) of the CPU's fp32 features of 4 of the images,
               the distance TF32 convolutions would give printed, one
               `utils.profiling.trace` naming convolution kernels; the int8
               quality protocol (`tools.int8_quality`) shortened: SD1.5
               at 512² (8 images in batches of 4, 8 DDIM steps, phase 4's
               weights; the int8 pipeline with the bf16 VAE, as bench.py
               runs it: one of its decodes launches K3 30 times, K2 once
               and no K5) and SD3 at 1024² under bf16 and int8 (2 images,
               4 steps, no T5): the eps errors, SSIM, FID floor and cross
               and the verdict printed (a record at these sizes, not a
               check), images finite in [0, 1], int8 unlike bf16, a bf16
               batch repeated bit for bit, the launches of each part; the
               `evaluation.fid` ref and calc entries on those images as
               PNGs (the set against itself within the eigh form's rounding
               floor) and `evaluation.mse` (0 against itself);
  8. sd3     - SD3 Prompt-Diffusion at full width (MMDiT 24 x 1536, the
               12-block ControlNet, CLIP-L, CLIP-bigG, T5-XXL, the z=16
               VAE; random weights from a seed) in the int8 serving mode of
               `bench.py --config sd3`: T5 staged (encode, free, then build
               the rest), two 1024² requests of batch 1, CFG 7, shift 3, 8
               of the bench's 28 flow-match steps; the image checks, the
               launches of the path's kernels, each quantized block kind
               against the plain ops, and one CFG velocity evaluation
               against the plain ops and an fp32-compute int8 evaluation;
               one request at 2 steps through GenerationServer(adapter=
               SD3Adapter(pipe)), bit-equal to `pipe.generate`;
  9. adaln   - K12 (called by no model) on the path a training step of an
               AdaLN site takes: the forward kernel, then the backward
               kernel through autograd, at the SD3 streams' shapes, each
               call one launch of each under the profiler;
 10. labs    - the attention lab entry point
               (`prompt_diffusion_tpu_torch.tools.attn_lab`), every lab at
               two timed iterations;
 11. midas   - the MiDaS DPT-Hybrid depth annotator at full width (ViT-B
               768 x 12, ResNetV2 (3, 4, 9), features 256; random weights
               from a seed; bf16) on two batches of 16 images at 512², as
               `bench.py --config annotate --annotator midas` runs it
               (x / 127.5 - 1 -> depth -> normals): the launches per
               forward of K3 (52, 33 with the ReLU epilogue), K1 (12) and
               K4 (24), outputs finite and in [0, 1], a bit-exact repeat,
               the raw depth against the plain ops (relative L2 <= 5e-2)
               and against an fp32-compute twin (no farther than 1.25x the
               plain ops); the same under the int8 policy (K6 24, K9 12,
               no K4 or K1) with one int8 ViT block against the plain ops;
               one DPT-Large forward (batch 2, K1 at 16 heads, the
               transposed convs) against the plain ops (5e-2) and an
               fp32-compute twin (1.25x the plain ops'); images/s;
     hed, seg, seg_int8, mlsd, openpose - the other annotators at full
               width on the same two batches (16 at 512², `bench.py
               --config annotate`): HED (VGG16, N(0, 1 / fan_in): N(0,
               0.02) makes its output vanish), UniFormer-S/UperNet in bf16 (N(0,
               0.02); exact launches per forward: K1 8, K4 22) and int8 (K9
               8, K9p 8, K6 22; no K1 or K4), M-LSD and the OpenPose body
               net (N(0, 2 / fan_in)); each: images/s, the first batch's
               time, peak memory, launches per forward, a bit-exact repeat,
               the output against the plain ops (relative L2 <= 5e-2);
               UniFormer's classes against an fp32-compute twin's (its
               disagreement at most 1.25x the plain bf16 ops' + 1e-4), its
               logits' std, and the share of classes that a bf16 logit
               upsample (the JAX package's) flips against the port's fp32
               one; one int8 SABlock against the plain ops; M-LSD's and
               OpenPose's detectors on 2 images each; the annotation pass
               (HED + UniFormer + MiDaS-Hybrid) in images/s; then the
               port's annotation entry's batch function with canny, hed,
               depth, normal and seg on 16 images (80 files);
 12. train   - training through the entries, at full width with random
               weights from a seed, on a synthetic EditDataset root of 512²
               images: SD1.5 at BASELINE config 5 (`train_sd15.main`, batch
               8 at 512², grad-accum 1, gradient checkpointing, EMA, bf16
               with fp32 masters), 3 steps saving at step 2, the saved
               state read back into a fresh state bit-equal (masters,
               moments, EMA, counters), one `--resume`d step whose draws
               equal the uninterrupted run's; UNet, VAE and CLIP
               bit-unchanged, the ControlNet moved; K1, K3 and K4 launched
               and their backwards run (the checkpoint recompute launches
               the forward kernels again: counted, not a fault), K2 in the
               VAE encode with no backward; one loss and ControlNet
               gradient (batch 2) through the kernels, on the plain ops
               and on an fp32-compute twin: the kernels' gradient and loss
               terms no farther from the fp32 ones than FP32_RATIO_BOUND
               times the plain ops'; the backward recomputes' device ms
               beside SDPA's backward; then SD3 (`train_sd3.main`, 24 + 12
               layers at 1536, batch 1 at 1024², 3 steps): the transformer
               and VAE bit-unchanged, the ControlNet and down_proj moved,
               K2 and K3 forward and backward; seconds per step, samples/s
               and peak memory beside the card's name and power limit;
 13. a JSON line of the kernels, then {"ok": true, "device": {...}}.
Every kernel case also prints the least time the card could take for its
work (`bound_ms`: bytes over 3.35 TB/s, tensor-core operations over the
dense peak or a softmax's exponentials over ~3.9e12/s, whichever is
largest; `prompt_diffusion_tpu_torch/tools/timing.py`; in the JSON line
`bound_by` is "bytes" or "operations", exponentials counting as
operations, and `bound_term` names the term) and, where one PyTorch call
computes the same function, that call's device time (`library_ms`),
timed here only. In the JSON line `ms`, `plain_ms` and `library_ms` are
device times. Each path phase sets every launch
count to 0 before it runs and reads them after. Imports nothing of JAX.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
ATTN_BOUND, NORM_BOUND, EPS_REL_BOUND = 3e-2, 2e-2, 5e-2
# At Nk = 4096 an attention output is ~0.03 in size, as large as ATTN_BOUND:
# the error must also stay within ATTN_REL_BOUND of the largest output.
ATTN_REL_BOUND = 2e-2
# With random weights the guided epsilon (CFG 9) amplifies bf16 rounding
# about 7x: the plain bf16 ops alone sit ~10% from an fp32 evaluation. The
# 5e-2 bound applies to the unguided outputs of ControlNet + UNet; the
# guided epsilon of the kernels must be no farther from the fp32 evaluation
# than FP32_RATIO_BOUND times the plain bf16 ops' distance.
FP32_RATIO_BOUND = 1.25
# Under the int8 policy every quantized site turns an fp32-ulp difference
# between the kernels and the plain ops into a whole int8 code step where a
# value sits at a rounding boundary, and the gap grows through the ~70
# quantized sites of ControlNet + UNet to the policy's own noise: the plain
# bf16 ops sit ~11% from an fp32-compute int8 evaluation there. So the int8
# path holds EPS_REL_BOUND block by block (one quantized block, the same
# input), and its unguided outputs to FP32_RATIO_BOUND times the plain ops'
# distance from the fp32-compute evaluation, like the guided epsilon.
# int8 epilogue kernels against their plain versions: the scales within
# SCALE_REL_BOUND, the codes at most 1 apart (an fp32 ulp can move a value
# across a rounding boundary) and at least CODES_EQUAL_BOUND of them equal.
SCALE_REL_BOUND, CODES_EQUAL_BOUND = 1e-6, 0.999
REQ_BATCH, REQ_SIZE, REQ_STEPS, CFG = 2, 512, 8, 9.0
PROMPTS = ("a photograph of a red house by a lake", "an oil painting of a mountain at dawn")
# SD3 requests as `bench.py --config sd3` makes them, cut to 8 of 28 steps
SD3_BATCH, SD3_SIZE, SD3_STEPS, SD3_CFG, SD3_SHIFT, T5_LEN = 1, 1024, 8, 7.0, 3.0, 256
# K12's gradient against the plain version's, relative to its largest value
GRAD_REL_BOUND = 1e-4
# K12's backward in bf16: one bf16 rounding of each gradient, at most
# BF16_ROUNDING of its largest value, beside the fp32 term GRAD_REL_BOUND
BF16_ROUNDING = 2.0 ** -8
LAB_ITERS = 2  # timed iterations of each attention lab variant in `[labs]`
# profiled calls of a plain version in `[kernels]` (a kernel's and a library
# call's: `device_ms`'s default, 20)
PLAIN_ITERS = 5
# `[serve]`: GenerationServer(max_batch=4, flush_ms=50) on the int8 pipeline;
# a burst of eight 512² requests at 8 steps, by (sampler, eta), each with its
# own seed, guidance in [5, 9] and control scale in [0.5, 1]
SERVE_MAX_BATCH, SERVE_FLUSH_MS = 4, 50.0
SERVE_BURST = (("unipc", 0.0),) * 4 + (("dpm++", 0.0),) * 2 + (("plms", 0.0), ("ddim", 0.5))
# steps of the co-batching experiment (one request with two sets of strangers)
COBATCH_STEPS = 4
# `[ckpt]`: files under a git-ignored directory, removed at the phase's end;
# a rank-4 LoRA's fused weights against W + B.A in fp64, rounded to the
# weight's dtype, relative to the weight's largest value; the SD3 folder's
# depth (MMDiT, ControlNet and T5 layers) and its request's steps
CKPT_DIR = os.path.join(REPO, "build", "ckpt_smoke")
LORA_RANK, LORA_REL_BOUND = 4, 1e-6
SD3_CKPT_LAYERS, SD3_CKPT_STEPS = 2, 2
# `[train]`: BASELINE config 5 (SD1.5 ControlNet, 512², batch 8, grad-accum
# 1, gradient checkpointing) through the entry, TRAIN_STEPS steps with a save
# at step 2, then one resumed step; the gradient check at GRAD_BATCH; SD3
# at full width, batch 1 at 1024² (a cut in batch only), SD3_TRAIN_STEPS
# steps; files under a git-ignored directory, removed at the phase's end
TRAIN_DIR = os.path.join(REPO, "build", "train_smoke")
TRAIN_BATCH, TRAIN_SIZE, TRAIN_STEPS, TRAIN_IMAGES = 8, 512, 3, 12
GRAD_BATCH = 2
SD3_TRAIN_BATCH, SD3_TRAIN_STEPS = 1, 3
# MiDaS as `bench.py --config annotate --annotator midas` runs it
MIDAS_BATCH, MIDAS_SIZE, MIDAS_BATCHES = 16, 512, 2
# K3's calls per CFG epsilon evaluation of the SD1.5 bf16 step (ControlNet +
# UNet): every GroupNorm of at least 2^18 elements
SD15_K3_PER_STEP = 88
# launches per DPT-Hybrid forward ("fused_group_norm.relu": K3's launches
# with the ReLU epilogue, among its 52): 1 stem + 16 blocks x 3 + 3
# downsample GroupNorms, 1 + 16 x 2 of them with ReLU; 12 ViT blocks
MIDAS_PER_FORWARD = {
    "midas": {"fused_group_norm": 52, "fused_group_norm.relu": 33,
              "flash_attention_packed": 12, "fused_layer_norm": 24,
              "flash_attention_packed_int8": 0, "quant_k_int8": 0, "fused_layer_norm_quant": 0},
    "midas_int8": {"fused_group_norm": 52, "fused_group_norm.relu": 33,
                   "flash_attention_packed_int8": 12, "quant_k_int8": 12,
                   "fused_layer_norm_quant": 24, "flash_attention_packed": 0,
                   "fused_layer_norm": 0},
    # DPT-Large: 24 ViT-L blocks, no GroupNorm
    "midas_large": {"flash_attention_packed": 24, "fused_layer_norm": 48,
                    "fused_group_norm": 0},
}


# the other annotators as `bench.py --config annotate` runs them: batch 16
# (bench.py:232) at 512², two batches each, random weights from a seed
ANN_BATCH, ANN_SIZE, ANN_BATCHES = 16, 512, 2
# launches per UniFormer-S forward: stage 3's 8 SABlocks at 1024 tokens take
# the packed attention (K1, or K9 and its K prologue under int8), stage 4's
# 3 at 256 tokens the plain one; both stages' 2 pre-LNs a block are K4 (K6
# under int8), 16 + 6; the patch and stage LayerNorms are plain
SEG_PER_FORWARD = {
    "seg": {"flash_attention_packed": 8, "fused_layer_norm": 22,
            "flash_attention_packed_int8": 0, "quant_k_int8": 0, "fused_layer_norm_quant": 0,
            "fused_group_norm": 0},
    "seg_int8": {"flash_attention_packed_int8": 8, "quant_k_int8": 8,
                 "fused_layer_norm_quant": 22, "flash_attention_packed": 0,
                 "fused_layer_norm": 0, "fused_group_norm": 0},
}
PER_FORWARD = {**MIDAS_PER_FORWARD, **SEG_PER_FORWARD}
# the UniFormer argmax against an fp32-compute twin's: the kernels' share of
# pixels whose class differs at most FP32_RATIO_BOUND times the plain bf16
# ops' share, plus SEG_FLIP_SLACK (a few pixels of a 512² batch of 16)
SEG_FLIP_SLACK = 1e-4
# `[notebook]`: run_prompt_diffusion.main at 512², 8 DDIM steps, per task
NOTEBOOK_TASKS, NOTEBOOK_SIZE, NOTEBOOK_STEPS = ("hed", "seg"), 512, 8
NOTEBOOK_DIR = os.path.join(REPO, "build", "notebook_smoke")
# `[eval]`: files under a git-ignored directory, removed at the phase's end;
# the int8 quality protocol shortened (SD1.5 at 512², 8 images in batches of
# 4, 8 DDIM steps, the int8 pipeline with the bf16 VAE as bench.py runs it;
# SD3 at 1024², 2 images of batch 1, 4 flow-match steps, bf16 and int8);
# the Inception extractor on a batch of 64 at 512² against the CPU's fp32
# features of 4 of the images, relative L2
EVAL_DIR = os.path.join(REPO, "build", "eval_smoke")
EVAL_N, EVAL_BATCH, EVAL_STEPS, EVAL_SD3_N, EVAL_SD3_STEPS = 8, 4, 8, 2, 4
EVAL_SD15 = ["--stack", "sd15", "--n", str(EVAL_N), "--batch", str(EVAL_BATCH), "--steps",
             str(EVAL_STEPS)]
EVAL_SD3 = ["--stack", "sd3", "--n", str(EVAL_SD3_N), "--batch", "1", "--steps",
            str(EVAL_SD3_STEPS)]
INCEPTION_BATCH, INCEPTION_SIZE, INCEPTION_CPU_IMAGES = 64, 512, 4
INCEPTION_CPU_REL_BOUND = 1e-4
# the `utils.profiling.annotate` span around the traced Inception batch
INCEPTION_SPAN = "inception batch"
# K3's launches per SD1.5 VAE decode: 2 GroupNorms in each of the 2 mid
# ResnetBlocks and the 12 up ResnetBlocks, the mid attention's, norm_out
SD15_K3_PER_DECODE = 30


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def log(msg):
    print(msg, flush=True)


def cldm_v15_yaml(model_channels=320, channel_mult=(1, 2, 4, 4), num_res_blocks=2,
                  attention_resolutions=(4, 2, 1), num_heads=8, context_dim=768, vae_ch=128,
                  vae_ch_mult=(1, 2, 4, 4), vae_res_blocks=2, hint_channels=6):
    """A model YAML in the layout of the reference's models/cldm_v15.yaml
    (`ControlLDM` with its control stage, UNet and first stage; the
    Prompt-Diffusion ControlNet takes a 6-channel hint), at the given
    widths: the defaults are the full SD1.5 widths. Written out here so
    that this script needs no file of the reference."""
    flow = lambda t: "[ " + ", ".join(str(v) for v in t) + " ]"
    block = lambda v: "".join(f"\n          - {x}" for x in v)
    unet = (f"""        image_size: 32 # unused
        in_channels: 4
        model_channels: {model_channels}
        attention_resolutions: {flow(attention_resolutions)}
        num_res_blocks: {num_res_blocks}
        channel_mult: {flow(channel_mult)}
        num_heads: {num_heads}
        use_spatial_transformer: True
        transformer_depth: 1
        context_dim: {context_dim}
        use_checkpoint: True
        legacy: False""")
    return f"""model:
  target: cldm.cldm.ControlLDM
  params:
    linear_start: 0.00085
    linear_end: 0.0120
    num_timesteps_cond: 1
    log_every_t: 200
    timesteps: 1000
    first_stage_key: "jpg"
    cond_stage_key: "txt"
    control_key: "hint"
    image_size: 64
    channels: 4
    cond_stage_trainable: false
    conditioning_key: crossattn
    monitor: val/loss_simple_ema
    scale_factor: 0.18215
    use_ema: False
    only_mid_control: False

    control_stage_config:
      target: cldm.cldm.ControlNet
      params:
        hint_channels: {hint_channels}
{unet}

    unet_config:
      target: cldm.cldm.ControlledUnetModel
      params:
        out_channels: 4
{unet}

    first_stage_config:
      target: ldm.models.autoencoder.AutoencoderKL
      params:
        embed_dim: 4
        monitor: val/rec_loss
        ddconfig:
          double_z: true
          z_channels: 4
          resolution: 256
          in_channels: 3
          out_ch: 3
          ch: {vae_ch}
          ch_mult:{block(vae_ch_mult)}
          num_res_blocks: {vae_res_blocks}
          attn_resolutions: []
          dropout: 0.0
        lossconfig:
          target: torch.nn.Identity

    cond_stage_config:
      # the CLIP ViT-L/14 text tower
      target: ldm.modules.encoders.modules.FrozenCLIPEmbedder
"""


def hash_token_ids(texts, max_length=77):
    """The ids the repository's HashTokenizer gives plain lowercase prompts
    (each word's md5 -> an id in [1000, 49000), between SOT 49406 and EOT
    49407, EOT-padded), written out here so that this script imports
    nothing of the JAX package."""
    import hashlib

    import numpy as np

    out = np.full((len(texts), max_length), 49407, dtype=np.int64)
    for i, text in enumerate(texts):
        words = [1000 + int(hashlib.md5(w.encode()).hexdigest()[:8], 16) % 48000
                 for w in text.lower().split()]
        ids = [49406] + words[: max_length - 2] + [49407]
        out[i, : len(ids)] = ids
    return out


def adaln_grads(x, scale, shift):
    """The gradients of sum(fused_adaln(x, scale, shift)^2) in x, scale and
    shift, flattened into one vector."""
    import torch

    from prompt_diffusion_tpu_torch.ops.fused_adaln import fused_adaln

    inputs = [a.detach().requires_grad_() for a in (x, scale, shift)]
    loss = fused_adaln(*inputs).float().square().sum()
    return torch.cat([g.flatten() for g in torch.autograd.grad(loss, inputs)])


def kernel_cases(gen):
    """(kernel name, case label, wrapper, arguments, kind, bound, work,
    library) at the main paths' shapes. Float inputs are seeded N(0, 1) in
    bf16; norm affines near (1, 0); int8 conv operands uniform codes and
    scales. `kind` is "float", "quant" (int8 codes and scales) or "exact".
    `work` is (bytes, int8 ops, bf16 ops, exponentials) of the function:
    each input read once, each output written once, one exponential per
    logit of a softmax. `library` is one PyTorch call that
    computes the same function on the same inputs, or None."""
    import torch
    import torch.nn.functional as F

    from prompt_diffusion_tpu_torch.ops.flash_attention import (
        attention_no_softmax,
        flash_attention,
        flash_attention_packed,
        flash_attention_packed_int8,
        flash_attention_packed_int8_rowk,
        flash_attention_tiled,
        flash_attention_two_pass,
        quant_k_int8,
    )
    from prompt_diffusion_tpu_torch.ops.fused_act import (
        fused_geglu_quant,
        fused_gelu_quant,
        fused_quant_rows,
    )
    from prompt_diffusion_tpu_torch.ops.fused_adaln import (
        fused_adaln,
        fused_adaln_bwd,
        fused_adaln_quant,
    )
    from prompt_diffusion_tpu_torch.ops.fused_group_norm import (
        fused_group_norm,
        fused_group_norm_quant,
    )
    from prompt_diffusion_tpu_torch.ops.fused_layer_norm import (
        fused_layer_norm,
        fused_layer_norm_quant,
    )
    from prompt_diffusion_tpu_torch.ops.int8_conv import conv3x3_int8, conv3x3_int8_xshift

    randn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    bf16 = lambda t: t.to(torch.bfloat16)
    affine = lambda c: (1 + 0.1 * randn(c), 0.1 * randn(c))
    heads = lambda t, h: t.unflatten(-1, (h, -1)).transpose(1, 2)  # (B, N, H*D) -> (B, H, N, D)
    cases = []
    # K1: the softmax scale is folded into q, the kernel runs at scale 1. The
    # headline shapes first (CFG batch 8), then the CFG batch 4 of two
    # batch-2 requests that the paths run, then ragged query and key tails
    for b, n, hd, h in ((8, 4096, 320, 8), (8, 1024, 640, 8), (4, 4096, 320, 8),
                        (4, 1024, 640, 8), (2, 1100, 80, 2)):
        q = bf16(randn(b, n, hd) * (hd // h) ** -0.5)
        k, v = bf16(randn(b, n, hd)), bf16(randn(b, n, hd))
        lib = (lambda q=q, k=k, v=v, h=h: F.scaled_dot_product_attention(
            heads(q, h), heads(k, h), heads(v, h), scale=1.0))
        cases.append(("flash_attention_packed", f"({b},{n},{hd}) H={h}", flash_attention_packed,
                      (q, k, v, h, 1.0), "float", ATTN_BOUND,
                      (8 * b * n * hd, 0, 4 * b * n * n * hd, b * h * n * n), lib))
    # K1 at the MiDaS DPT-Hybrid ViT-B (batch 16 at 512²: 1025 tokens, 12
    # heads of 64, ragged against the 64-key tile) on the column slices of
    # one packed qkv projection, unscaled, as the ViT block calls it
    b, n, hd, h = 16, 1025, 768, 12
    q, k, v = bf16(randn(b, n, 3 * hd)).chunk(3, dim=-1)
    cases.append(("flash_attention_packed", f"({b},{n},{hd}) H={h} ViT-B qkv slices",
                  flash_attention_packed, (q, k, v, h, 64 ** -0.5), "float", ATTN_BOUND,
                  (8 * b * n * hd, 0, 4 * b * n * n * hd, b * h * n * n),
                  lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                      heads(q, 12), heads(k, 12), heads(v, 12), scale=64 ** -0.5)))
    # K1 at UniFormer-S stage 3 (batch 16 at 512²: 1024 tokens, 5 heads of
    # 64) on the column slices of one packed qkv projection, unscaled
    b, n, hd, h = 16, 1024, 320, 5
    q, k, v = bf16(randn(b, n, 3 * hd)).chunk(3, dim=-1)
    cases.append(("flash_attention_packed", f"({b},{n},{hd}) H={h} UniFormer qkv slices",
                  flash_attention_packed, (q, k, v, h, 64 ** -0.5), "float", ATTN_BOUND,
                  (8 * b * n * hd, 0, 4 * b * n * n * hd, b * h * n * n),
                  lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                      heads(q, 5), heads(k, 5), heads(v, 5), scale=64 ** -0.5)))
    # K1 on K9's work, for reference: the SD3 joint shape in bf16
    b, n, hd, h = 2, 4429, 1536, 24
    q, k, v = (bf16(randn(b, n, hd)) for _ in range(3))
    cases.append(("flash_attention_packed", f"({b},{n},{hd}) H={h} K9's SD3 work in bf16",
                  flash_attention_packed, (q, k, v, h, 64 ** -0.5), "float", ATTN_BOUND,
                  (8 * b * n * hd, 0, 4 * b * n * n * hd, b * h * n * n),
                  lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                      heads(q, h), heads(k, h), heads(v, h), scale=64 ** -0.5)))
    # K2 at the VAE mid-attention: SD1.5 at 512² (batch 4), SD3 at 1024²
    # (batch 1), then ragged query and key tails
    for b, n in ((4, 4096), (1, 16384), (1, 1100)):
        qkv = tuple(bf16(randn(b, n, 1, 512)) for _ in range(3))
        cases.append(("flash_attention", f"({b},{n},1,512)", flash_attention, qkv, "float",
                      ATTN_BOUND, (8 * b * n * 512, 0, 4 * b * n * n * 512, b * n * n),
                      lambda qkv=qkv: F.scaled_dot_product_attention(*(t.transpose(1, 2)
                                                                       for t in qkv))))
    # K2 at the MMDiT's joint attention under the bf16 policy (CFG batch 2,
    # 4096 + 333 tokens, 24 heads of 64), on `JointBlock.attention`'s
    # layout: (B, N, H*D) projections viewed as (B, N, H, D), default scale
    b, n, h, d = 2, 4429, 24, 64
    qkv = tuple(bf16(randn(b, n, h * d)).unflatten(-1, (h, d)) for _ in range(3))
    cases.append(("flash_attention", f"({b},{n},{h},{d}) MMDiT joint", flash_attention, qkv,
                  "float", ATTN_BOUND, (8 * b * n * h * d, 0, 4 * b * n * n * h * d, b * h * n * n),
                  lambda qkv=qkv: F.scaled_dot_product_attention(*(t.transpose(1, 2)
                                                                   for t in qkv))))
    # K9 at the SD3 joint shape (CFG batch 2, 4096 + 333 tokens, 24 heads
    # of 64), then ragged query and key tails
    for b, n, hd, h in ((2, 4429, 1536, 24), (2, 1100, 256, 4)):
        q, k, v = (bf16(randn(b, n, hd)) for _ in range(3))
        cases.append(("flash_attention_packed_int8", f"({b},{n},{hd}) H={h}",
                      flash_attention_packed_int8, (q, k, v, h), "float", ATTN_BOUND,
                      (8 * b * n * hd, 2 * b * n * n * hd, 2 * b * n * n * hd, b * h * n * n),
                      None))
    # K9 at the MiDaS DPT-Hybrid ViT-B under int8 (batch 16 at 512²), on
    # the column slices of one packed qkv projection
    b, n, hd, h = 16, 1025, 768, 12
    q, k, v = bf16(randn(b, n, 3 * hd)).chunk(3, dim=-1)
    cases.append(("flash_attention_packed_int8", f"({b},{n},{hd}) H={h} ViT-B qkv slices",
                  flash_attention_packed_int8, (q, k, v, h), "float", ATTN_BOUND,
                  (8 * b * n * hd, 2 * b * n * n * hd, 2 * b * n * n * hd, b * h * n * n), None))
    vit_k = k
    # K9 at UniFormer-S stage 3 under int8 (batch 16 at 512², 5 heads of 64)
    b, n, hd, h = 16, 1024, 320, 5
    q, k, v = bf16(randn(b, n, 3 * hd)).chunk(3, dim=-1)
    cases.append(("flash_attention_packed_int8", f"({b},{n},{hd}) H={h} UniFormer qkv slices",
                  flash_attention_packed_int8, (q, k, v, h), "float", ATTN_BOUND,
                  (8 * b * n * hd, 2 * b * n * n * hd, 2 * b * n * n * hd, b * h * n * n), None))
    # K9's prologue, K to int8 codes and scales, bit-equal to its plain
    # version: per head at the SD3 joint shape and on the ViT-B's and
    # UniFormer's K column slices, per key row at the lab's SD3 shape (the
    # ROWK mode's)
    for b, n, hd, h, per_row, k, site in (
            (2, 4429, 1536, 24, False, bf16(randn(2, 4429, 1536)), ""),
            (16, 1025, 768, 12, False, vit_k, " ViT-B K slice"),
            (2, 4250, 1536, 24, True, bf16(randn(2, 4250, 1536)), ""),
            (16, 1024, 320, 5, False, k, " UniFormer K slice")):
        scales = b * h * (n if per_row else 1)
        cases.append(("quant_k_int8", f"({b},{n},{hd}) H={h}" + (" per row" if per_row else "")
                      + site, quant_k_int8, (k, h, per_row),
                      "exact", 0.0, (3 * b * n * hd + 4 * scales, 0, 0), None))
    gn_shapes = (((8, 320, 64, 64), 1e-5, 0.0), ((4, 128, 512, 512), 1e-6, 4.0))
    for name, fn, kind, bound, out_bytes in (
            ("fused_group_norm", fused_group_norm, "float", NORM_BOUND, 2),
            ("fused_group_norm_quant", fused_group_norm_quant, "quant", None, 1)):
        for shape, eps, mean in gn_shapes:
            x = bf16(randn(*shape) + mean).contiguous(memory_format=torch.channels_last)
            cases.append((name, f"{shape} eps={eps} mean={mean} silu", fn,
                          (x, *affine(shape[1]), 32, eps, True), kind, bound,
                          ((2 + out_bytes) * x.numel(), 0, 0), None))
    # K3 after the cases above (the first stays the headline): without SiLU
    # (the SpatialTransformer norm, the VAE attention norm), where one
    # PyTorch call computes it, at the SD3 VAE's shapes at 1024², and at an
    # 8² site (latency)
    for shape, eps, mean, silu in (((8, 320, 64, 64), 1e-6, 0.0, False),
                                   ((1, 512, 128, 128), 1e-6, 0.0, False),
                                   ((1, 512, 128, 128), 1e-6, 0.0, True),
                                   ((1, 128, 1024, 1024), 1e-6, 4.0, True),
                                   ((8, 1280, 8, 8), 1e-5, 0.0, True)):
        x = bf16(randn(*shape) + mean).contiguous(memory_format=torch.channels_last)
        w, bb = affine(shape[1])
        lib = None if silu else (lambda x=x, w=w, bb=bb, eps=eps: F.group_norm(
            x, 32, w.to(x.dtype), bb.to(x.dtype), eps))
        cases.append(("fused_group_norm", f"{shape} eps={eps} mean={mean} "
                      + ("silu" if silu else "no silu"), fused_group_norm,
                      (x, w, bb, 32, eps, silu), "float", NORM_BOUND, (4 * x.numel(), 0, 0), lib))
    # K3 in fp32 at the widest SD1.5 site under the fp32 policy (8², C =
    # 2560: two 16-byte vectors a thread)
    x = randn(8, 2560, 8, 8).contiguous(memory_format=torch.channels_last)
    cases.append(("fused_group_norm", "(8, 2560, 8, 8) eps=1e-05 mean=0.0 silu fp32",
                  fused_group_norm, (x, *affine(2560), 32, 1e-5, True), "float", NORM_BOUND,
                  (8 * x.numel(), 0, 0), None))
    # K3's ReLU epilogue at the MiDaS DPT-Hybrid backbone (batch 16 at 512²):
    # the stem's norm and stage 3's narrowest; no single PyTorch call
    # computes GroupNorm + ReLU
    for shape in ((16, 64, 256, 256), (16, 256, 32, 32)):
        x = bf16(randn(*shape)).contiguous(memory_format=torch.channels_last)
        cases.append(("fused_group_norm", f"{shape} eps=1e-05 mean=0.0 relu", fused_group_norm,
                      (x, *affine(shape[1]), 32, 1e-5, False, True), "float", NORM_BOUND,
                      (4 * x.numel(), 0, 0), None))
    x, (w, bb) = bf16(randn(32768, 320)), affine(320)
    cases.append(("fused_layer_norm", "(32768,320)", fused_layer_norm, (x, w, bb, 1e-5), "float",
                  NORM_BOUND, (4 * x.numel(), 0, 0),
                  lambda x=x, w=w, bb=bb: F.layer_norm(x, (320,), w.to(x.dtype), bb.to(x.dtype),
                                                       1e-5)))
    # K4 at the MiDaS ViT-B pre-LNs (batch 16 x 1025 tokens of 768, eps 1e-6)
    x, (w, bb) = bf16(randn(16400, 768)), affine(768)
    cases.append(("fused_layer_norm", "(16400,768) eps=1e-06 ViT-B", fused_layer_norm,
                  (x, w, bb, 1e-6), "float", NORM_BOUND, (4 * x.numel(), 0, 0),
                  lambda x=x, w=w, bb=bb: F.layer_norm(x, (768,), w.to(x.dtype), bb.to(x.dtype),
                                                       1e-6)))
    # K4 at the UniFormer-S SABlock pre-LNs (batch 16 at 512², eps 1e-6):
    # stage 3's 16 x 1024 tokens of 320, stage 4's 16 x 256 of 512
    for n, c in ((16384, 320), (4096, 512)):
        x, (w, bb) = bf16(randn(n, c)), affine(c)
        cases.append(("fused_layer_norm", f"({n},{c}) eps=1e-06 UniFormer", fused_layer_norm,
                      (x, w, bb, 1e-6), "float", NORM_BOUND, (4 * x.numel(), 0, 0),
                      lambda x=x, w=w, bb=bb, c=c: F.layer_norm(
                          x, (c,), w.to(x.dtype), bb.to(x.dtype), 1e-6)))
    # K6 at the SD1.5 pre-LN rows of CFG batch 8 (64², 32², 16², 8²), a
    # ragged row count, the DPT-Hybrid ViT-B's (eps 1e-6), fp32 rows and
    # the UniFormer-S SABlocks' (eps 1e-6)
    for n, c, eps, dt in ((32768, 320, 1e-5, torch.bfloat16), (8192, 640, 1e-5, torch.bfloat16),
                          (2048, 1280, 1e-5, torch.bfloat16), (512, 1280, 1e-5, torch.bfloat16),
                          (1000, 640, 1e-5, torch.bfloat16), (16400, 768, 1e-6, torch.bfloat16),
                          (1000, 640, 1e-5, torch.float32), (16384, 320, 1e-6, torch.bfloat16),
                          (4096, 512, 1e-6, torch.bfloat16)):
        site = " ViT-B" if c == 768 else " UniFormer" if eps == 1e-6 else ""
        cases.append(("fused_layer_norm_quant", f"({n},{c})" + site
                      + (" fp32" if dt == torch.float32 else ""), fused_layer_norm_quant,
                      (randn(n, c).to(dt), *affine(c), eps), "quant", None,
                      ((dt.itemsize + 1) * n * c + 4 * n + 8 * c, 0, 0), None))
    # K5 beyond the cases above: the widest SD1.5 site (the first 64²
    # decoder ResBlock's in_norm, 63 MB at CFG batch 8, beyond the L2), an
    # 8² site (latency), and without SiLU (the SpatialTransformer norm)
    for shape, eps, silu in (((8, 960, 64, 64), 1e-5, True), ((8, 2560, 8, 8), 1e-5, True),
                             ((8, 320, 64, 64), 1e-6, False)):
        x = bf16(randn(*shape)).contiguous(memory_format=torch.channels_last)
        cases.append(("fused_group_norm_quant", f"{shape} eps={eps} mean=0.0 "
                      + ("silu" if silu else "no silu"), fused_group_norm_quant,
                      (x, *affine(shape[1]), 32, eps, silu), "quant", None,
                      (3 * x.numel() + 4 * shape[0], 0, 0), None))
    # K7 at the SD1.5 feed-forward rows of CFG batch 8 (64², 32², 8²) and a
    # ragged row count
    for n, c in ((32768, 2560), (512, 10240), (8192, 5120), (333, 2560)):
        cases.append(("fused_geglu_quant", f"({n},{c})", fused_geglu_quant,
                      (bf16(randn(n, c)),), "quant", None, (2 * n * c + n * c // 2 + 4 * n, 0, 0),
                      None))
    # K13 at the SD3 image and context streams, per-sample modulation; then
    # with scale and shift as the MMDiT passes them, strided (B, 1, C)
    # chunks of one (B, 1, 6C) bf16 projection
    for b, n, c in ((2, 4096, 1536), (2, 333, 1536)):
        args = (bf16(randn(b, n, c)), bf16(0.1 * randn(b, 1, c)), bf16(0.1 * randn(b, 1, c)))
        cases.append(("fused_adaln_quant", f"({b},{n},{c})", fused_adaln_quant, args, "quant",
                      None, (3 * b * n * c + 4 * b * c + 4 * b * n, 0, 0), None))
    for b, n, c in ((2, 4096, 1536), (2, 333, 1536)):
        shift, scale = bf16(0.1 * randn(b, 1, 6 * c)).chunk(6, dim=-1)[:2]
        cases.append(("fused_adaln_quant", f"({b},{n},{c}) (B,1,6C) chunks", fused_adaln_quant,
                      (bf16(randn(b, n, c)), scale, shift), "quant", None,
                      (3 * b * n * c + 4 * b * c + 4 * b * n, 0, 0), None))
    # K12 at the same shapes (the context stream's modulation as (B, C)),
    # then its gradient in fp32: forward read and write, backward reads of x
    # and the output gradient, writes of the three gradients
    for b, n, c in ((2, 4096, 1536), (2, 333, 1536)):
        x, s = bf16(randn(b, n, c)), bf16(0.1 * randn(b, 1, c))
        t = bf16(0.1 * randn(b, 1, c) if n > 1000 else 0.1 * randn(b, c))
        cases.append(("fused_adaln", f"({b},{n},{c})", fused_adaln, (x, s, t), "float",
                      NORM_BOUND, (4 * b * n * c + 4 * b * c, 0, 0), None))
    b, n, c = 2, 4096, 1536
    args = (randn(b, n, c), 0.1 * randn(b, 1, c), 0.1 * randn(b, 1, c))
    cases.append(("fused_adaln", f"({b},{n},{c}) fp32 gradient", adaln_grads, args, "grad",
                  GRAD_REL_BOUND, (20 * b * n * c + 16 * b * c, 0, 0), None))
    # K12's backward alone against the plain backward: fp32 at the image
    # stream, then bf16 at both streams (the context stream's modulation as
    # (B, C)); reads of x, the output gradient and scale, writes of dx,
    # dscale and dshift
    for b, n, c, dt in ((2, 4096, 1536, torch.float32), (2, 4096, 1536, torch.bfloat16),
                        (2, 333, 1536, torch.bfloat16)):
        x, g = randn(b, n, c).to(dt), randn(b, n, c).to(dt)
        s = (0.1 * randn(b, 1, c) if n > 1000 else 0.1 * randn(b, c)).to(dt)
        size = x.element_size()
        cases.append(("fused_adaln_bwd", f"({b},{n},{c}) {str(dt)[6:]}", fused_adaln_bwd,
                      (x, s, g), "bwd",
                      GRAD_REL_BOUND + (BF16_ROUNDING if dt == torch.bfloat16 else 0.0),
                      (3 * size * b * n * c + 3 * size * b * c, 0, 0), None))
    # K10 at the MMDiT FF width (both streams' rows; one tanh per value on
    # the special-function units)
    for n in (8192, 666):
        cases.append(("fused_gelu_quant", f"({n},6144)", fused_gelu_quant,
                      (bf16(2 * randn(n, 6144)),), "quant", None,
                      (3 * n * 6144 + 4 * n, 0, 0, n * 6144), None))
    # K11 as the MMDiT calls it, on the image and context slices of one
    # packed (B, N_h + N_c, C) attention output at CFG batch 2, read in
    # place; then on contiguous rows of both streams
    attn = bf16(2 * randn(2, 4429, 1536))
    for x in (attn[:, :4096], attn[:, 4096:], bf16(2 * randn(8192, 1536)),
              bf16(2 * randn(666, 1536))):
        rows = x.numel() // 1536
        label = (f"({rows},1536)" if x.is_contiguous() else
                 f"{tuple(x.shape)} slice of {tuple(attn.shape)}")
        cases.append(("fused_quant_rows", label, fused_quant_rows, (x,), "quant", None,
                      (3 * rows * 1536 + 4 * rows, 0, 0), None))
    codes = lambda *s: torch.randint(-127, 128, s, generator=gen, device="cuda",
                                     dtype=torch.int8)
    uniform = lambda n, lo, hi: lo + (hi - lo) * torch.rand(n, generator=gen, device="cuda")
    # K8, both variants: the SD1.5 sites that carry most of a step's
    # operations at CFG batch 8 (64², 32², 16²; the 8² latents, which take
    # split-K), a Cin that 128 does not divide, the latent input conv (Cin =
    # 4) at CFG batch 8 and 4, two ragged shapes (pixel, channel and K tails
    # in both load paths; no bias with fp32 output) and the int8 VAE's 512²
    # rows, wider than xshift's tile.
    conv_shapes = ((8, 64, 64, 320, 320, True, torch.bfloat16),
                   (8, 32, 32, 640, 640, True, torch.bfloat16),
                   (8, 16, 16, 1280, 1280, True, torch.bfloat16),
                   (8, 8, 8, 1280, 1280, True, torch.bfloat16),
                   (8, 8, 8, 2560, 1280, True, torch.bfloat16),
                   (8, 64, 64, 960, 320, True, torch.bfloat16),
                   (8, 64, 64, 4, 320, True, torch.bfloat16),
                   (2, 64, 64, 4, 320, True, torch.bfloat16),
                   (3, 5, 11, 48, 72, True, torch.bfloat16),
                   (2, 7, 9, 24, 40, False, torch.float32),
                   (2, 512, 512, 128, 128, True, torch.bfloat16))
    for name, fn in (("conv3x3_int8", conv3x3_int8), ("conv3x3_int8_xshift", conv3x3_int8_xshift)):
        for b, h, w, cin, cout, bias, dt in conv_shapes:
            args = (codes(b, h, w, cin), uniform(b, 0.01, 0.1), codes(cout, 3, 3, cin),
                    uniform(cout, 1e-4, 1e-3), randn(cout) if bias else None, dt)
            label = f"({b},{h},{w},{cin}->{cout})" + ("" if bias else " no bias, fp32 out")
            out_bytes = 2 if dt == torch.bfloat16 else 4
            nbytes = b * h * w * (cin + out_bytes * cout) + 9 * cin * cout + 4 * (b + 2 * cout)
            cases.append((name, label, fn, args, "exact", 0.0,
                          (nbytes, 2 * b * h * w * cout * 9 * cin, 0), None))
    # the attention lab modes at the SD1.5 64² self-attention (B, N, H, D),
    # the two-pass mode also at heads padded to 64, and the per-row-K int8
    # mode at the SD3 joint shape
    b, n, h = 8, 4096, 8
    sdpa = lambda q, k, v, s: (lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=s))
    for name, fn, d, bq, bk, lib in (
            ("flash_attention_tiled", flash_attention_tiled, 40, 128, 128, True),
            ("attention_no_softmax", attention_no_softmax, 40, 64, 64, False),
            ("flash_attention_two_pass", flash_attention_two_pass, 40, 64, 64, True),
            ("flash_attention_two_pass", flash_attention_two_pass, 64, 128, 64, True)):
        q, k, v = (bf16(randn(b, n, h, d)) for _ in range(3))
        cases.append((name, f"({b},{n},{h},{d}) bq{bq} bk{bk}", fn,
                      (q, k, v, d ** -0.5, bq, bk), "float", ATTN_BOUND,
                      (8 * b * n * h * d, 0, 4 * b * n * n * h * d, b * h * n * n if lib else 0),
                      sdpa(q, k, v, d ** -0.5) if lib else None))
    b, n, hd, h = 2, 4250, 1536, 24
    q, k, v = (bf16(randn(b, n, hd)) for _ in range(3))
    cases.append(("flash_attention_packed_int8_rowk", f"({b},{n},{hd}) H={h}",
                  flash_attention_packed_int8_rowk, (q, k, v, h), "float", ATTN_BOUND,
                  (8 * b * n * hd, 2 * b * n * n * hd, 2 * b * n * n * hd, b * h * n * n), None))
    return cases


def compare_quant(out, ref):
    """(max abs error of the dequantized values, largest relative scale
    error, largest code difference, share of equal codes)."""
    (q, s), (rq, rs) = out, ref
    scale_err = ((s - rs).abs() / rs).max().item()
    diff = (q.int() - rq.int()).abs()
    shape = (-1,) + (1,) * (q.ndim - 1) if s.ndim == 1 else s.shape
    deq = lambda codes, scale: codes.float() * scale.reshape(shape)
    err = (deq(q, s) - deq(rq, rs)).abs().max().item()
    return err, scale_err, diff.max().item(), (diff == 0).float().mean().item()


def phase_kernels(gen):
    """Every kernel against its plain version; returns per-kernel results.

    The float kernels' bound applies against the plain version evaluated in
    fp32 on the same bf16 inputs, as tests/test_ops.py bounds the TPU
    kernel: the kernel's own bf16 rounding is then the only rounding
    compared. The error against the plain version in bf16 is printed
    beside it. For attention the bound is also ATTN_REL_BOUND of the
    largest output, and it must be smaller than the error of the plain
    version with the first key tile left out, the smallest key tile the
    attention kernels use: a kernel that skipped a tile would fail it. The
    no-softmax lab mode sums rather than averages V, so its output grows
    with sqrt(Nk) and only the relative bound applies.
    The int8 epilogue kernels are held to their scales and codes (the plain
    versions quantize the fp32 value of the same bf16 inputs); the int8
    conv to bit equality; AdaLN's gradient to GRAD_REL_BOUND of its
    largest value, and AdaLN's backward alone each of its gradients to its
    bound times the gradient's largest plain value."""
    import torch

    from prompt_diffusion_tpu_torch.ops.dispatch import plain_ops
    from prompt_diffusion_tpu_torch.ops.flash_attention import LAB_TILES, WIDE_TILE
    from prompt_diffusion_tpu_torch.tools.conv_tune import bf16_conv
    from prompt_diffusion_tpu_torch.tools.timing import (
        device_launches,
        device_ms,
        roofline,
        time_ms,
    )

    key_tile = min(tile[1] for tile in LAB_TILES + (WIDE_TILE,))
    fp32 = lambda args: tuple(a.float() if torch.is_tensor(a) and a.dtype == torch.bfloat16
                              else a for a in args)
    results, t0, profiled_s = {}, time.perf_counter(), 0.0
    for name, label, fn, args, kind, bound, work, library in kernel_cases(gen):
        out = fn(*args)
        with plain_ops():
            ref = fn(*fp32(args))
        torch.cuda.synchronize()
        extra = {}
        if kind == "quant":
            check(all(torch.isfinite(t).all().item() for t in (out[1], ref[1])),
                  f"{name} {label}: non-finite scales")
            err, scale_err, code_diff, equal = compare_quant(out, ref)
            extra = {"scale_rel_err": scale_err, "max_code_diff": code_diff,
                     "codes_equal": equal}
            msg = (f"dequantized max_abs_err={err}; scales within {scale_err} relative (bound "
                   f"{SCALE_REL_BOUND}), codes at most {code_diff} apart, {equal} equal "
                   f"(bound {CODES_EQUAL_BOUND})")
            ok = (scale_err <= SCALE_REL_BOUND and code_diff <= 1 and equal >= CODES_EQUAL_BOUND)
        elif kind == "bwd":  # K12's backward: dx, dscale, dshift
            check(all(torch.isfinite(t).all().item() for t in out),
                  f"{name} {label}: non-finite gradients")
            errs = [(a.float() - r.float()).abs().max().item() for a, r in zip(out, ref)]
            bounds = [bound * r.abs().max().item() for r in ref]
            err = max(errs)
            extra = {"errors": errs, "bounds": bounds}
            msg = (f"dx, dscale, dshift max_abs_err={errs} (bounds {bounds}: {bound} of each "
                   f"largest plain gradient in fp32)")
            ok = all(e <= bb for e, bb in zip(errs, bounds))
        elif kind == "exact" and isinstance(out, tuple):  # K9's prologue: codes and scales
            err = max((a.float() - r.float()).abs().max().item() for a, r in zip(out, ref))
            msg = f"codes and scales max_abs_err={err} (bit-equal required)"
            ok = all(torch.equal(a, r) for a, r in zip(out, ref))
        else:
            check(torch.isfinite(out).all().item(), f"{name} {label}: non-finite output")
            err = (out.float() - ref.float()).abs().max().item()
            if kind == "grad":
                bound = GRAD_REL_BOUND * ref.abs().max().item()
            elif name == "attention_no_softmax":
                bound = ATTN_REL_BOUND * ref.abs().max().item()
            elif name.startswith("flash_attention"):
                bound = min(bound, ATTN_REL_BOUND * ref.abs().max().item())
            if "attention" in name:
                q, k, v, *rest = fp32(args)
                with plain_ops():
                    short = fn(q, k[:, key_tile:], v[:, key_tile:], *rest)
                tile_err = (short - ref).abs().max().item()
                log(f"[kernels] {name} {label}: bound {bound}; plain version without one "
                    f"{key_tile}-key tile is {tile_err} off")
                check(tile_err > bound, f"{name} {label}: bound {bound} would pass a missing "
                                        f"key tile ({tile_err})")
                del short
            msg = f"max_abs_err={err} (bound {bound}, against the plain version in fp32)"
            ok = err <= bound and (kind != "exact" or torch.equal(out, ref))
        if kind == "float":
            with plain_ops():
                ref_bf16 = fn(*args)
            extra["err_vs_plain_bf16"] = (out.float() - ref_bf16.float()).abs().max().item()
            msg += f" err_vs_plain_bf16={extra['err_vs_plain_bf16']}"
            del ref_bf16
        one = name in ONE_LAUNCH and kind != "grad"  # a gradient case runs many kernels
        if kind == "quant" or one:  # K5's, K3's, K9p's and K12's backward's sums cross blocks
            again = fn(*args)
            pairs = zip(out, again) if isinstance(out, tuple) else ((out, again),)
            extra["repeat_bit_equal"] = all(torch.equal(a, b) for a, b in pairs)
            del again
            msg += f"; repeat bit-equal {extra['repeat_bit_equal']}"
            ok = ok and extra["repeat_bit_equal"]
        if one:
            extra["launches_per_call"] = device_launches(lambda: fn(*args))
            msg += f"; {extra['launches_per_call']} device launches per call (1 required)"
            ok = ok and extra["launches_per_call"] == 1
        del out, ref
        t = time.perf_counter()
        ms = device_ms(lambda: fn(*args), launches=1 if one else None)
        with plain_ops():
            plain_ms = device_ms(lambda: fn(*args), iters=PLAIN_ITERS, warmup=1)
        lib_ms = None if library is None else device_ms(library)
        if name.startswith("conv3x3_int8"):  # the bar an int8 conv must clear to pay
            extra["bf16_conv_ms"] = device_ms(bf16_conv(gen, *args[0].shape, args[2].shape[0]))
        profiled_s += time.perf_counter() - t
        wall_ms = time_ms(lambda: fn(*args))
        bound_ms, bound_term = roofline(*work)
        bound_by = "bytes" if bound_term == "bytes" else "operations"
        log(f"[kernels] {name} {label}: {msg} device_ms={ms} plain_device_ms={plain_ms} "
            f"library_device_ms={lib_ms} wall_ms={wall_ms} bound_ms={bound_ms} ({bound_term})"
            + ("" if "bf16_conv_ms" not in extra else f" bf16_conv_device_ms="
               f"{extra['bf16_conv_ms']} (cuDNN bf16, not the same function)"))
        check(ok, f"{name} {label}: outside its bound: {msg}")
        results.setdefault(name, []).append(
            {"case": label, "max_abs_err": err, "bound": bound, **extra, "ms": ms,
             "plain_ms": plain_ms, "library_ms": lib_ms, "wall_ms": wall_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "bound_term": bound_term})
    log(f"[kernels] {sum(len(c) for c in results.values())} cases in "
        f"{time.perf_counter() - t0:.1f}s, {profiled_s:.1f}s of it under the profiler")
    return results


def k3_k5_statistics(gen):
    """K3 and K5 take their group statistics from one code path: on one
    fp32 tensor at the SD1.5 64² site (SiLU), K3's output (fp32, so its
    pre-cast value) lies within one code step of K5's dequantized codes,
    and rounding it by K5's scale gives K5's codes (printed: the share)."""
    import torch

    from prompt_diffusion_tpu_torch.ops.fused_group_norm import (
        fused_group_norm,
        fused_group_norm_quant,
    )

    x = torch.randn((8, 320, 64, 64), generator=gen, device="cuda").contiguous(
        memory_format=torch.channels_last)
    w = 1 + 0.1 * torch.randn(320, generator=gen, device="cuda")
    b = 0.1 * torch.randn(320, generator=gen, device="cuda")
    y = fused_group_norm(x, w, b, 32, 1e-5, True)
    q, s = fused_group_norm_quant(x, w, b, 32, 1e-5, True)
    step = s.view(-1, 1, 1, 1)
    steps = ((y - q.float() * step).abs() / step).max().item()
    same = (torch.clamp(torch.round(y / step), -127, 127) == q.float()).float().mean().item()
    log(f"[kernels] K3 vs K5 on one fp32 (8,320,64,64) tensor, SiLU: K3's output within "
        f"{steps} code steps of K5's dequantized codes (bound 1); rounded by K5's scale it "
        f"gives K5's codes for {same} of the values")
    check(steps <= 1.0, f"K3's statistics are not K5's: {steps} code steps apart")
    return {"max_code_steps": steps, "codes_equal": same}


KERNELS = {  # name -> (route, source, TPU kernel it replaces)
    "flash_attention_packed": ("cuda", "prompt_diffusion_tpu_torch/ops/csrc/flash_attention.cu",
                               "prompt_diffusion_tpu/ops/flash_attention.py:322"),
    "flash_attention": ("cuda", "prompt_diffusion_tpu_torch/ops/csrc/flash_attention.cu",
                        "prompt_diffusion_tpu/ops/flash_attention.py:163"),
    "fused_group_norm": ("cuda", "prompt_diffusion_tpu_torch/ops/csrc/gn_quant.cu",
                         "prompt_diffusion_tpu/ops/fused_group_norm.py:128"),
    "fused_layer_norm": ("triton", "prompt_diffusion_tpu_torch/ops/_triton_norms.py",
                         "prompt_diffusion_tpu/ops/fused_layer_norm.py:90"),
    "fused_group_norm_quant": ("cuda", "prompt_diffusion_tpu_torch/ops/csrc/gn_quant.cu",
                               "prompt_diffusion_tpu/ops/fused_group_norm.py:86"),
    "fused_layer_norm_quant": ("cuda", "prompt_diffusion_tpu_torch/ops/csrc/row_quant.cu",
                               "prompt_diffusion_tpu/ops/fused_layer_norm.py:149"),
    "fused_geglu_quant": ("cuda", "prompt_diffusion_tpu_torch/ops/csrc/row_quant.cu",
                          "prompt_diffusion_tpu/ops/fused_act.py:144"),
    "conv3x3_int8": ("cuda", "prompt_diffusion_tpu_torch/ops/csrc/int8_conv.cu",
                     "prompt_diffusion_tpu/ops/int8_conv.py:174"),
    "flash_attention_packed_int8": ("cuda", "prompt_diffusion_tpu_torch/ops/csrc/int8_attention.cu",
                                    "prompt_diffusion_tpu/ops/flash_attention.py:375"),
    "fused_gelu_quant": ("cuda", "prompt_diffusion_tpu_torch/ops/csrc/row_quant.cu",
                         "prompt_diffusion_tpu/ops/fused_act.py:101"),
    "fused_quant_rows": ("cuda", "prompt_diffusion_tpu_torch/ops/csrc/row_quant.cu",
                         "prompt_diffusion_tpu/ops/fused_act.py:106"),
    "fused_adaln_quant": ("cuda", "prompt_diffusion_tpu_torch/ops/csrc/row_quant.cu",
                          "prompt_diffusion_tpu/ops/fused_adaln.py:140"),
    "fused_adaln": ("cuda", "prompt_diffusion_tpu_torch/ops/csrc/row_quant.cu",
                    "prompt_diffusion_tpu/ops/fused_adaln.py:95"),
    # K12's backward: the JAX `custom_vjp` `_bwd`, jnp beside the pallas_call
    "fused_adaln_bwd": ("cuda", "prompt_diffusion_tpu_torch/ops/csrc/row_quant.cu",
                        "prompt_diffusion_tpu/ops/fused_adaln.py:127"),
    "conv3x3_int8_xshift": ("cuda", "prompt_diffusion_tpu_torch/ops/csrc/int8_conv.cu",
                            "prompt_diffusion_tpu/ops/int8_conv.py:103"),
    "flash_attention_tiled": ("cuda", "prompt_diffusion_tpu_torch/ops/csrc/flash_attention.cu",
                              "tools/attn_variants.py:41"),
    "attention_no_softmax": ("cuda", "prompt_diffusion_tpu_torch/ops/csrc/flash_attention.cu",
                             "tools/attn_variants.py:41"),
    "flash_attention_two_pass": ("cuda", "prompt_diffusion_tpu_torch/ops/csrc/flash_attention.cu",
                                 "tools/attn_variants.py:76"),
    "flash_attention_packed_int8_rowk": (
        "cuda", "prompt_diffusion_tpu_torch/ops/csrc/int8_attention.cu",
        "tools/attn_int8_lab.py:46"),
    # K9's prologue: the K quantization of K9's own function, which JAX
    # computes in XLA beside its Pallas call
    "quant_k_int8": ("cuda", "prompt_diffusion_tpu_torch/ops/csrc/int8_attention.cu",
                     "prompt_diffusion_tpu/ops/flash_attention.py:391"),
}
# kernels whose wrapper must issue exactly one device launch per call (no
# cast or copy of its inputs), counted in a profiler trace in `[kernels]`
# (K12's gradient case, which runs both K12 kernels and plain ops, aside)
ONE_LAUNCH = ("fused_gelu_quant", "fused_adaln_quant", "fused_geglu_quant",
              "fused_group_norm_quant", "fused_layer_norm_quant", "fused_quant_rows",
              "fused_group_norm", "quant_k_int8", "fused_adaln", "fused_adaln_bwd")
# the device functions a wrapper launches, where it launches more than one
# (K9's wrapper runs its prologue, then the attention kernel; K8's adds the
# split-K sum and epilogue where its plan splits K)
DEVICE_FUNCTIONS = {
    "conv3x3_int8": ("conv3x3_int8_kernel", "splitk_epilogue_kernel"),
    "conv3x3_int8_xshift": ("conv3x3_int8_xshift_kernel", "splitk_epilogue_kernel"),
    "flash_attention_packed_int8": ("k_head_quant_kernel", "int8_attn_kernel"),
    "flash_attention_packed_int8_rowk": ("k_row_codes_kernel", "int8_attn_kernel"),
    "quant_k_int8": ("k_head_quant_kernel", "k_row_codes_kernel"),
}
# on the paths: each call of these wrappers is one launch of its device
# function, and no device function of their parent designs runs
# (`one_launch_per_call`)
PATH_ONE_LAUNCH = {"fused_group_norm": "gn_float_kernel", "quant_k_int8": "k_head_quant_kernel",
                   "fused_adaln": "adaln_float_kernel", "fused_adaln_bwd": "adaln_bwd_kernel"}
PARENT_FUNCTIONS = ("gn_stats_kernel", "gn_combine_kernel", "gn_apply_kernel", "k_amax_kernel",
                    "k_codes_kernel", "adaln_kernel")
# further TPU kernels a kernel stands for: the lab kernels that compute the
# same function as one above
ALSO_REPLACES = {
    "flash_attention_two_pass": ("tools/attn_variants.py:169", "tools/attn_lab2.py:47",
                                 "tools/attn_lab2.py:66", "tools/attn_lab3.py:47"),
    "flash_attention_packed_int8": ("tools/attn_int8_lab.py:105",),
}
# the kernels each main path must launch (K4 LayerNorm does not run in int8
# mode: every pre-LN there quantizes through K6)
PATH_KERNELS = {
    "slice": ("flash_attention_packed", "flash_attention", "fused_group_norm",
              "fused_layer_norm"),
    "int8": ("flash_attention_packed", "flash_attention", "fused_group_norm",
             "fused_group_norm_quant", "fused_layer_norm_quant", "fused_geglu_quant",
             "conv3x3_int8"),
    # the server's burst: the int8 path's kernels under every sampler
    "serve": ("flash_attention_packed", "flash_attention", "fused_group_norm",
              "fused_group_norm_quant", "fused_layer_norm_quant", "fused_geglu_quant",
              "conv3x3_int8"),
    # [ckpt]: the bf16 SD1.5 requests and LoRA, serve.main --ckpt under int8,
    # the generate entry (bf16), the int8 SD3 folder
    "ckpt": ("flash_attention_packed", "flash_attention", "fused_group_norm",
             "fused_layer_norm", "fused_group_norm_quant", "fused_layer_norm_quant",
             "fused_geglu_quant", "conv3x3_int8", "flash_attention_packed_int8",
             "quant_k_int8", "fused_gelu_quant", "fused_quant_rows", "fused_adaln_quant"),
    # request 1 again through a pipeline built with conv_variant="xshift"
    "int8_xshift": ("conv3x3_int8_xshift", "fused_group_norm_quant", "flash_attention_packed"),
    # the bf16 VAE's GroupNorm and mid-block attention, the int8 MMDiT's four
    "sd3": ("flash_attention", "fused_group_norm", "flash_attention_packed_int8",
            "quant_k_int8", "fused_gelu_quant", "fused_quant_rows", "fused_adaln_quant"),
    "adaln": ("fused_adaln", "fused_adaln_bwd"),
    "labs": ("flash_attention_tiled", "attention_no_softmax", "flash_attention_two_pass",
             "flash_attention_packed_int8_rowk", "flash_attention_packed_int8",
             "flash_attention_packed"),
    # SD1.5 training (the forward kernels; their backwards are counted as
    # "<name>.backward"): the VAE encode (K2, K3) and ControlNet + UNet
    "train": ("flash_attention_packed", "flash_attention", "fused_group_norm",
              "fused_layer_norm"),
    # SD3 training: the joint attention and the VAE (K2), the VAE's GroupNorm
    "train_sd3": ("flash_attention", "fused_group_norm"),
    # the annotation entry's batch with canny, hed, depth, normal and seg
    "annotate": ("fused_group_norm", "flash_attention_packed", "fused_layer_norm"),
    **{tag: tuple(k for k, n in counts.items() if n and "." not in k)
       for tag, counts in PER_FORWARD.items()},
    # HED, M-LSD and OpenPose run convs, pools and resizes only: no kernel of
    # the port (every count must stay 0)
    "hed": (), "mlsd": (), "openpose": (),
    # run_prompt_diffusion.main: HED or UniFormer on the example, then SD1.5
    # bf16 from a checkpoint
    "notebook": ("flash_attention_packed", "flash_attention", "fused_group_norm",
                 "fused_layer_norm"),
    # [eval]: create_model's request 1 (SD1.5 bf16)
    "eval_config": ("flash_attention_packed", "flash_attention", "fused_group_norm",
                    "fused_layer_norm"),
    # the quality protocol's SD1.5 run: the eps checks and the generation
    # under bf16 and under int8 with the bf16 VAE
    "eval_sd15": ("flash_attention_packed", "flash_attention", "fused_group_norm",
                  "fused_layer_norm", "fused_group_norm_quant", "fused_layer_norm_quant",
                  "fused_geglu_quant", "conv3x3_int8"),
    # one bf16 batch again (the repeat check)
    "eval_sd15_bf16": ("flash_attention_packed", "flash_attention", "fused_group_norm",
                       "fused_layer_norm"),
    # one decode of the int8 pipeline's bf16 VAE: K3 and the mid attention
    "eval_decode": ("flash_attention", "fused_group_norm"),
    # the protocol's SD3 run under bf16 (joint attention as K2) and int8
    "eval_sd3": ("flash_attention", "fused_group_norm", "flash_attention_packed_int8",
                 "quant_k_int8", "fused_gelu_quant", "fused_quant_rows", "fused_adaln_quant"),
    "eval_sd3_bf16": ("flash_attention", "fused_group_norm"),
    # the Inception extractor and the FID entries: cuDNN convolutions only
    "eval_fid": (),
}


class _BackwardLaunches:
    """K12's backward launches, `fused_adaln.backward_launches`, as the
    `launches` of a wrapper."""

    @property
    def launches(self):
        from prompt_diffusion_tpu_torch.ops.fused_adaln import fused_adaln

        return fused_adaln.backward_launches

    @launches.setter
    def launches(self, value):
        from prompt_diffusion_tpu_torch.ops.fused_adaln import fused_adaln

        fused_adaln.backward_launches = value


def wrappers():
    from prompt_diffusion_tpu_torch.ops import flash_attention as fa
    from prompt_diffusion_tpu_torch.ops import fused_act as act
    from prompt_diffusion_tpu_torch.ops import fused_adaln as ada
    from prompt_diffusion_tpu_torch.ops import fused_group_norm as gn
    from prompt_diffusion_tpu_torch.ops import fused_layer_norm as ln
    from prompt_diffusion_tpu_torch.ops import int8_conv as ic

    return {"flash_attention_packed": fa.flash_attention_packed,
            "flash_attention": fa.flash_attention,
            "fused_group_norm": gn.fused_group_norm,
            "fused_layer_norm": ln.fused_layer_norm,
            "fused_group_norm_quant": gn.fused_group_norm_quant,
            "fused_layer_norm_quant": ln.fused_layer_norm_quant,
            "fused_geglu_quant": act.fused_geglu_quant,
            "conv3x3_int8": ic.conv3x3_int8,
            "flash_attention_packed_int8": fa.flash_attention_packed_int8,
            "fused_gelu_quant": act.fused_gelu_quant,
            "fused_quant_rows": act.fused_quant_rows,
            "fused_adaln_quant": ada.fused_adaln_quant,
            "fused_adaln": ada.fused_adaln,
            "fused_adaln_bwd": _BackwardLaunches(),
            "conv3x3_int8_xshift": ic.conv3x3_int8_xshift,
            "flash_attention_tiled": fa.flash_attention_tiled,
            "attention_no_softmax": fa.attention_no_softmax,
            "flash_attention_two_pass": fa.flash_attention_two_pass,
            "flash_attention_packed_int8_rowk": fa.flash_attention_packed_int8_rowk,
            "quant_k_int8": fa.quant_k_int8}


# the wrappers with a gradient whose backward recomputes the plain version
# (`backward_calls`, read as "<name>.backward")
DIFFERENTIABLE = ("flash_attention_packed", "flash_attention", "fused_group_norm",
                  "fused_layer_norm")


def reset_launches():
    """Every launch count and backward count to 0; returns the wrappers by
    kernel name."""
    counted = wrappers()
    for w in counted.values():
        w.launches = 0
    counted["fused_group_norm"].relu_launches = 0
    for name in DIFFERENTIABLE:
        counted[name].backward_calls = 0
    return counted


def read_launches(counted):
    """{kernel name: launches}, K3's launches with the ReLU epilogue under
    "fused_group_norm.relu", and the backward calls of K1-K4 under
    "<name>.backward"."""
    launches = {name: w.launches for name, w in counted.items()}
    launches["fused_group_norm.relu"] = counted["fused_group_norm"].relu_launches
    launches.update({f"{n}.backward": counted[n].backward_calls for n in DIFFERENTIABLE})
    return launches


def one_launch_per_call(tag, fn):
    """Runs `fn` under the profiler: each call of a PATH_ONE_LAUNCH wrapper
    made during the run is one launch of its device function, and no
    device function of the parent designs runs (a trace that lost
    activities is taken again, up to `timing.PROFILE_TRIES` runs in all).
    Returns (fn's result, the launches of the run)."""
    from prompt_diffusion_tpu_torch.tools.timing import (
        PROFILE_TRIES,
        device_kernels,
        device_trace,
    )

    for attempt in range(PROFILE_TRIES):
        counted = reset_launches()
        with device_trace() as prof:
            out = fn()
        launches = read_launches(counted)
        names = [name for name, _, _ in device_kernels(prof)]
        found = {w: sum(f in n for n in names) for w, f in PATH_ONE_LAUNCH.items()}
        parents = sorted({n for n in names if any(f in n for f in PARENT_FUNCTIONS)})
        if all(found[w] == launches[w] for w in found) or attempt == PROFILE_TRIES - 1:
            break
    log(f"[{tag}] under the profiler: " + ", ".join(
        f"{w} {launches[w]} calls, {found[w]} launches of {f}" for w, f in PATH_ONE_LAUNCH.items())
        + f"; device functions of the parent designs: {parents or 'none'}")
    for w, f in PATH_ONE_LAUNCH.items():
        check(found[w] == launches[w], f"[{tag}] {w}: {launches[w]} calls but {found[w]} "
                                       f"launches of {f}")
    check(not parents, f"[{tag}] the parent designs ran: {parents}")
    return out, launches


def twin(pipe, policy):
    """The pipeline with copies of its UNet and ControlNet under another
    policy (same weights), sharing its VAE and text encoder."""
    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15

    other = PromptDiffusionSD15.create(policy=policy, vae=pipe.vae,
                                       text_encoder=pipe.text_encoder, device="cuda")
    other.unet.load_state_dict(pipe.unet.state_dict())
    other.controlnet.load_state_dict(pipe.controlnet.state_dict())
    return other


def int8_block_checks(pipe, seed=4000):
    """One quantized block of each kind, the same seeded input through the
    kernels and through the plain ops: relative L2 within EPS_REL_BOUND."""
    import torch

    from prompt_diffusion_tpu_torch.ops.dispatch import plain_ops

    g = torch.Generator(device="cuda").manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
    act = lambda b, c, hw: randn(b, c, hw, hw).contiguous(memory_format=torch.channels_last)
    b, lat, img = 2 * REQ_BATCH, REQ_SIZE // 8, REQ_SIZE
    unet, dec = pipe.unet, pipe.vae.decoder
    blocks = {
        "UNet input conv (4->320)": (unet.input_blocks_0_conv, (act(b, 4, lat),)),
        "UNet ResBlock 320 at 64²": (unet.input_blocks_1_res,
                                     (act(b, 320, lat), randn(b, 1280))),
        "UNet SpatialTransformer 320 at 64²": (unet.input_blocks_1_attn,
                                               (act(b, 320, lat), randn(b, 77, 768))),
        "UNet Downsample 320": (unet.input_blocks_3_down, (act(b, 320, lat),)),
        "UNet ResBlock 2560->1280 at 8²": (unet.output_blocks_0_res,
                                           (act(b, 2560, lat // 8), randn(b, 1280))),
        "VAE ResnetBlock 256->128 at 512²": (dec.up_0_block_0,
                                             (act(REQ_BATCH, 256, img),)),
        "VAE attention 512 at 64²": (dec.mid_attn_1, (act(REQ_BATCH, 512, lat),)),
    }
    rel = lambda a, b: ((a.float() - b.float()).norm() / b.float().norm()).item()
    with torch.no_grad():
        for name, (module, args) in blocks.items():
            out = module(*args)
            with plain_ops():
                ref = module(*args)
            err = rel(out, ref)
            log(f"[int8] block {name}, kernels vs plain ops on the same input: rel L2 {err} "
                f"(bound {EPS_REL_BOUND})")
            check(err <= EPS_REL_BOUND, f"block {name}: rel L2 {err} > {EPS_REL_BOUND}")


def sd15_request(i):
    """Request i (0 or 1) of the SD1.5 paths: `generate`'s keyword
    arguments, the generator that draws x_T included."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(1000 + i)
    cond = lambda c: torch.rand((REQ_BATCH, REQ_SIZE, REQ_SIZE, c), generator=g,
                                device="cuda") * 2 - 1
    return dict(
        token_ids=torch.from_numpy(hash_token_ids([PROMPTS[i]] * REQ_BATCH)),
        neg_token_ids=torch.from_numpy(hash_token_ids([""] * REQ_BATCH)),
        example_pair=cond(6), query=cond(3),
        generator=torch.Generator(device="cuda").manual_seed(2000 + i),
    )


def phase_path(tag, policy, vae_int8, ref_policy, info_policy=None, seed=0, keep_pipe=False):
    """Two full-width requests through the port's public API under
    `policy`, the launch counts of the path's kernels, and one CFG epsilon
    evaluation (t=999) against the plain ops and against `ref_policy`
    (fp32 compute) on the plain ops. `info_policy` adds the distance from
    another policy's evaluation, printed only. Under the int8 policy a
    pipeline built with conv_variant="xshift" and the same weights then
    answers request 1 again (the "int8_xshift" path). Returns {path tag:
    (launches, timing)}, and with `keep_pipe` the pipeline and request 1's
    images too."""
    import numpy as np
    import torch

    from prompt_diffusion_tpu_torch.ops.dispatch import plain_ops
    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15
    from prompt_diffusion_tpu_torch.tools.timing import time_ms
    from prompt_diffusion_tpu_torch.utils.dtypes import random_init_

    t0 = time.perf_counter()
    pipe = PromptDiffusionSD15.create(policy=policy, vae_int8=vae_int8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for m in (pipe.unet, pipe.controlnet, pipe.vae, pipe.text_encoder):
        random_init_(m, gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (pipe.unet, pipe.controlnet, pipe.vae, pipe.text_encoder)
                   for p in m.parameters())
    log(f"[{tag}] SD1.5 built with random weights: {n_params} parameters "
        f"in {time.perf_counter() - t0:.1f}s")

    def answer(i, p=pipe):
        t = time.perf_counter()
        img = p.generate(**sd15_request(i), num_steps=REQ_STEPS, guidance_scale=CFG)
        torch.cuda.synchronize()
        return img, time.perf_counter() - t

    counted = reset_launches()
    img1, s1 = answer(0)
    img2, s2 = answer(1)
    launches = {name: w.launches for name, w in counted.items()}
    log(f"[{tag}] request 1: {s1:.3f}s, request 2: {s2:.3f}s; launches {launches}")
    for name in PATH_KERNELS[tag]:
        check(launches[name] > 0, f"kernel {name} was not launched on the {tag} path")
    for img in (img1, img2):
        check(tuple(img.shape) == (REQ_BATCH, REQ_SIZE, REQ_SIZE, 3), f"shape {tuple(img.shape)}")
        check(torch.isfinite(img).all().item(), "non-finite image")
        check(img.min().item() >= 0.0 and img.max().item() <= 1.0, "image outside [0, 1]")
    check(not torch.equal(img1, img2), "the two requests gave the same images")
    img1b, s1b = answer(0)
    check(torch.equal(img1, img1b), "request 1 with the same generator gave other images")
    log(f"[{tag}] images {tuple(img1.shape)} finite in [0,1]; requests differ; "
        f"request 1 repeated bit-exactly in {s1b:.3f}s; std {img1.float().std().item():.4f}")
    (img1c, _), again = one_launch_per_call(tag, lambda: answer(0))
    check(torch.equal(img1, img1c), "request 1 under the profiler gave other images")
    for name in PATH_ONE_LAUNCH:
        check(2 * again[name] == launches[name],
              f"[{tag}] {name}: {again[name]} calls in request 1, {launches[name]} in two")

    if tag == "int8":
        int8_block_checks(pipe)

    # one CFG epsilon evaluation (ControlNet + UNet at t=999), kernels vs plain
    r = sd15_request(0)
    r.pop("generator")
    eps_fns = {gs: pipe.make_eps_fn(**r, guidance_scale=gs) for gs in (0.0, 1.0, CFG)}
    g = torch.Generator(device="cuda").manual_seed(3000)
    x = torch.randn((REQ_BATCH, 4, REQ_SIZE // 8, REQ_SIZE // 8), generator=g, device="cuda")
    x = x.contiguous(memory_format=torch.channels_last)
    t = torch.full((REQ_BATCH,), 999, dtype=torch.int32, device="cuda")
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    with torch.no_grad():
        kern = {gs: f(x, t) for gs, f in eps_fns.items()}
        if tag == "slice":
            counted = reset_launches()
            eps_fns[CFG](x, t)
            per_step = read_launches(counted)["fused_group_norm"]
            log(f"[slice] K3 calls per CFG epsilon evaluation: {per_step} (expected "
                f"{SD15_K3_PER_STEP})")
            check(per_step == SD15_K3_PER_STEP, f"[slice] {per_step} K3 calls per step")
        with plain_ops():
            plain = {gs: f(x, t) for gs, f in eps_fns.items()}
            ref = twin(pipe, ref_policy)
            eps32 = {gs: ref.make_eps_fn(**r, guidance_scale=gs)(x, t) for gs in eps_fns}
            del ref
        info = (None if info_policy is None else
                twin(pipe, info_policy).make_eps_fn(**r, guidance_scale=CFG)(x, t))
        step_s = time_ms(lambda: eps_fns[CFG](x, t), iters=5, warmup=1) / 1e3
    # the uncond and cond outputs of ControlNet + UNet (guidance 0 and 1)
    rel_branches = rel(torch.cat([kern[0.0], kern[1.0]]), torch.cat([plain[0.0], plain[1.0]]))
    rel_k32, rel_p32 = rel(kern[CFG], eps32[CFG]), rel(plain[CFG], eps32[CFG])
    rel_branches_p32 = rel(torch.cat([plain[0.0], plain[1.0]]),
                           torch.cat([eps32[0.0], eps32[1.0]]))
    branch_bound = EPS_REL_BOUND if tag == "slice" else FP32_RATIO_BOUND * rel_branches_p32
    log(f"[{tag}] eps (t=999), kernels vs plain ops: rel L2 {rel_branches} over the uncond "
        f"and cond outputs (bound {branch_bound}; the plain ops' own distance from the "
        f"fp32-compute evaluation there: {rel_branches_p32}); guided (CFG {CFG}) "
        f"{rel(kern[CFG], plain[CFG])}")
    log(f"[{tag}] guided eps against an fp32-compute evaluation of the same weights and "
        f"policy on the plain ops: kernels {rel_k32}, plain ops {rel_p32} (bound "
        f"{FP32_RATIO_BOUND}x the plain ops')")
    if info is not None:
        log(f"[{tag}] guided eps against the bf16 policy's (kernels, same weights), for "
            f"information: {rel(kern[CFG], info)}")
    check(np.isfinite(rel_branches) and rel_branches <= branch_bound,
          f"eps rel L2 {rel_branches} > {branch_bound}")
    check(rel_k32 <= FP32_RATIO_BOUND * rel_p32,
          f"kernels {rel_k32} vs plain {rel_p32} from the fp32-compute evaluation")
    paths = {tag: (launches, {"request_s": [s1, s2, s1b], "step_s": step_s})}
    if tag == "int8":
        # request 1 through K8's xshift kernel: the same bits as im2col
        xpipe = PromptDiffusionSD15.create(policy=policy, vae_int8=vae_int8, device="cuda",
                                           conv_variant="xshift")
        for name, m in xpipe.jax_modules().items():
            m.load_state_dict(pipe.jax_modules()[name].state_dict())
        counted = reset_launches()
        img_x, s_x = answer(0, xpipe)
        launches_x = {name: w.launches for name, w in counted.items()}
        with torch.no_grad():
            eps_x = xpipe.make_eps_fn(**r, guidance_scale=CFG)
            step_x = time_ms(lambda: eps_x(x, t), iters=5, warmup=1) / 1e3
            step_s = time_ms(lambda: eps_fns[CFG](x, t), iters=5, warmup=1) / 1e3
        log(f"[int8] xshift request 1: {s_x:.3f}s; launches {launches_x}")
        for name in PATH_KERNELS["int8_xshift"]:
            check(launches_x[name] > 0, f"kernel {name} was not launched on the xshift request")
        check(launches_x["conv3x3_int8"] == 0, "the xshift request launched the im2col kernel")
        check(torch.equal(img_x, img1), "the xshift request's images differ from im2col's")
        log(f"[int8] xshift request 1 bit-equal to the im2col request; K8 launches per request "
            f"im2col {launches['conv3x3_int8'] // 2}, xshift {launches_x['conv3x3_int8_xshift']}"
            f"; seconds per denoise step im2col {step_s:.4f}, xshift {step_x:.4f} (timed in "
            f"turn)")
        paths["int8_xshift"] = (launches_x, {"request_s": [s_x], "step_s": step_x,
                                             "im2col_step_s": step_s})
        del xpipe, eps_x
    if keep_pipe:
        return paths, pipe, img1
    del pipe
    torch.cuda.empty_cache()
    return paths


def serve_request(i, sampler="unipc", eta=0.0, steps=REQ_STEPS, n=len(SERVE_BURST)):
    """Request i of a burst of n: its own seed, example pair and query,
    guidance from 5 to 9 and control scale from 0.5 to 1 across the burst."""
    import numpy as np

    from prompt_diffusion_tpu_torch.serving import GenerationRequest

    rng = np.random.default_rng(6000 + i)
    img = lambda c: rng.uniform(-1, 1, (REQ_SIZE, REQ_SIZE, c)).astype(np.float32)
    frac = i / max(n - 1, 1)
    return GenerationRequest(
        token_ids=hash_token_ids([PROMPTS[i % 2]])[0], neg_token_ids=hash_token_ids([""])[0],
        example_pair=img(6), query=img(3), num_steps=steps, guidance_scale=5.0 + 4.0 * frac,
        control_scale=0.5 + 0.5 * frac, eta=eta, sampler=sampler, seed=7000 + i)


def recording_adapter(pipe):
    """An SD15Adapter that records each batch it runs: (the padded
    requests, seconds to the images on the host)."""
    import torch

    from prompt_diffusion_tpu_torch.serving import SD15Adapter

    class Recording(SD15Adapter):
        def __init__(self, pipe):
            super().__init__(pipe)
            self.batches = []

        def execute(self, padded):
            t = time.perf_counter()
            out = super().execute(padded)
            torch.cuda.synchronize()
            self.batches.append((list(padded), time.perf_counter() - t))
            return out

    return Recording(pipe)


def serve_burst(pipe, reqs, **config):
    """`reqs` submitted at once to a fresh GenerationServer over `pipe`
    (warmed first when `warm`): (images by seed, the batches it ran, the
    burst's seconds, the server's stats of the burst, the launch counts of
    the burst, set to 0 after the warm-up)."""
    from prompt_diffusion_tpu_torch.serving import GenerationServer, ServerConfig

    warm = config.pop("warm", False)
    adapter = recording_adapter(pipe)
    server = GenerationServer(pipe, ServerConfig(**config), adapter=adapter)
    if warm:  # every bucket once, at 2 steps
        server.warmup(serve_request(0, steps=2))
    adapter.batches.clear()
    before = dict(server.stats)
    counted = reset_launches()
    with server:
        t0 = time.perf_counter()
        futs = [server.submit(r) for r in reqs]
        images = {r.seed: f.result(timeout=900) for r, f in zip(reqs, futs)}
        burst_s = time.perf_counter() - t0
    launches = read_launches(counted)
    stats = {k: server.stats[k] - before[k] for k in before}
    return images, list(adapter.batches), burst_s, stats, launches


def phase_serve(pipe, card):
    """The micro-batching server over the int8 SD1.5 pipeline at full
    width: a burst of eight requests (four UniPC, two DPM-Solver++, one
    PLMS, one DDIM at eta 0.5), each image checked, the burst batched with
    the UniPC requests in one batch, each batch bit-equal to
    `pipe.generate` on the same inputs, the int8 path's kernels launched;
    one UniPC request at batch 1 through the kernels no farther from an
    fp32-compute evaluation than 1.25x the plain ops; the co-batching
    contract bit-equal under the bf16 policy (and the int8 policy's
    difference printed); seconds per request by sampler, requests/s."""
    import numpy as np
    import torch

    from prompt_diffusion_tpu_torch.models.vae import AutoencoderKL
    from prompt_diffusion_tpu_torch.ops.dispatch import plain_ops
    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15
    from prompt_diffusion_tpu_torch.serving import SD15Adapter
    from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy

    reqs = [serve_request(i, sampler, eta) for i, (sampler, eta) in enumerate(SERVE_BURST)]
    images, batches, burst_s, stats, launches = serve_burst(
        pipe, reqs, max_batch=SERVE_MAX_BATCH, flush_ms=SERVE_FLUSH_MS, warm=True)
    log(f"[serve] burst of {len(reqs)} requests ({REQ_SIZE}², {REQ_STEPS} steps, int8 policy, "
        f"int8 VAE): {burst_s:.3f}s, {len(reqs) / burst_s:.3f} requests/s; stats {stats}; "
        f"batches " + ", ".join(f"{b[0][0].sampler} x{len(b[0])} {b[1]:.3f}s" for b in batches))
    log(f"[serve] launches {launches}")
    # check 1: the images, and the batching
    for seed, img in images.items():
        check(img.shape == (REQ_SIZE, REQ_SIZE, 3), f"[serve] image shape {img.shape}")
        check(np.isfinite(img).all() and img.min() >= 0.0 and img.max() <= 1.0,
              f"[serve] request {seed}: non-finite or outside [0, 1]")
    check(stats["requests"] == len(reqs) and stats["batches"] < len(reqs),
          f"[serve] {stats['batches']} batches for {len(reqs)} requests")
    unipc = {r.seed for r in reqs if r.sampler == "unipc"}
    check(any({r.seed for r in padded} == unipc for padded, _ in batches),
          "[serve] the four UniPC requests did not run as one batch")
    # check 3: the kernels of the int8 path ran on the server's path
    for name in PATH_KERNELS["serve"]:
        check(launches[name] > 0, f"kernel {name} was not launched on the serve path")
    # check 2: the server adds nothing; also the direct call's seconds per request
    adapter, direct_s, served_s = SD15Adapter(pipe), {}, {}
    for padded, secs in batches:
        t = time.perf_counter()
        ref = pipe.generate(**adapter.inputs(padded)).cpu().numpy()
        sampler, n = padded[0].sampler, len({r.seed for r in padded})
        direct_s.setdefault(sampler, []).append((time.perf_counter() - t) / n)
        served_s.setdefault(sampler, []).append(secs / n)
        for k, r in enumerate(padded[:n]):
            check(np.array_equal(images[r.seed], ref[k]),
                  f"[serve] request {r.seed} ({sampler}) differs from pipe.generate's")
    log("[serve] every batch bit-equal to pipe.generate on the same stacked inputs, noise "
        "and scales")
    # check 4: a UniPC trajectory at batch 1, kernels and plain ops against fp32 compute
    one = adapter.inputs([serve_request(0)])
    f32 = DTypePolicy(compute_dtype=torch.float32, quant="int8")
    with torch.no_grad():
        img_k = pipe.generate(**one)
        with plain_ops():
            img_p = pipe.generate(**one)
            with torch.device("cuda"):
                vae32 = AutoencoderKL(policy=f32)
            vae32.load_state_dict(pipe.vae.state_dict())
            ref = PromptDiffusionSD15.create(policy=f32, vae=vae32,
                                             text_encoder=pipe.text_encoder, device="cuda")
            ref.unet.load_state_dict(pipe.unet.state_dict())
            ref.controlnet.load_state_dict(pipe.controlnet.state_dict())
            img_32 = ref.generate(**one)
            del ref, vae32
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    rel_k32, rel_p32 = rel(img_k, img_32), rel(img_p, img_32)
    log(f"[serve] UniPC request at batch 1 ({REQ_STEPS} steps): image against an fp32-compute "
        f"int8 evaluation of the same weights on the plain ops: kernels {rel_k32}, plain ops "
        f"{rel_p32} (bound {FP32_RATIO_BOUND}x the plain ops'); kernels vs plain ops "
        f"{rel(img_k, img_p)}")
    check(np.isfinite(rel_k32) and rel_k32 <= FP32_RATIO_BOUND * rel_p32,
          f"[serve] UniPC image: kernels {rel_k32} vs plain {rel_p32} from fp32 compute")
    # check 5: one request twice, each time with three other strangers, bucket 4
    target = serve_request(0, steps=COBATCH_STEPS)
    sets = [[target] + [serve_request(10 + 3 * k + j, steps=COBATCH_STEPS, n=16)
                        for j in range(3)] for k in range(2)]
    bf16 = PromptDiffusionSD15.create(text_encoder=pipe.text_encoder, device="cuda")
    for name in ("unet", "controlnet", "vae"):
        getattr(bf16, name).load_state_dict(getattr(pipe, name).state_dict())

    def cobatched(p):
        out = []
        for reqs4 in sets:
            imgs, runs, _, _, _ = serve_burst(p, reqs4, max_batch=SERVE_MAX_BATCH,
                                              flush_ms=SERVE_FLUSH_MS)
            check([[r.seed for r in padded] for padded, _ in runs] ==
                  [[r.seed for r in reqs4]], f"[serve] the co-batch ran as {runs}")
            out.append(imgs[target.seed])
        return out

    a, b = cobatched(bf16)
    del bf16
    a8, b8 = cobatched(pipe)
    log(f"[serve] co-batching: one request beside two sets of three strangers (bucket 4, "
        f"{COBATCH_STEPS} steps): bf16 policy bit-equal {np.array_equal(a, b)}; int8 policy "
        f"max abs difference {float(np.abs(a8 - b8).max())} (per-tensor activation scales "
        f"couple the batch; printed, not checked)")
    check(np.array_equal(a, b), "[serve] bf16: a request's image depends on its strangers")
    per_req = {k: float(np.mean(v)) for k, v in served_s.items()}
    log(f"[serve] {card}: seconds per request by sampler, served (batch time / requests) "
        + ", ".join(f"{k} {v:.3f}" for k, v in per_req.items()) + "; direct generate "
        + ", ".join(f"{k} {np.mean(v):.3f}" for k, v in direct_s.items())
        + f"; {len(reqs) / burst_s:.3f} requests/s over the burst")
    torch.cuda.empty_cache()
    return launches, {"burst_s": burst_s, "requests_per_s": len(reqs) / burst_s,
                      "s_per_request": per_req, "stats": stats}


def read_png(path):
    """An 8-bit RGB PNG written by `serve.write_png` -> (H, W, 3) uint8."""
    import struct
    import zlib

    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is not a PNG")
    pos, chunks = 8, {}
    while pos < len(data):
        (n,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        chunks[tag] = chunks.get(tag, b"") + data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h = struct.unpack(">II", chunks[b"IHDR"][:8])
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + 3 * w)
    check((raw[:, 0] == 0).all(), f"{path}: a row filter other than 0")
    return raw[:, 1:].reshape(h, w, 3)


def to_png_values(images):
    """Float images in [0, 1] -> the 8-bit values `serve.write_png` stores."""
    import numpy as np

    return np.clip(np.rint(np.asarray(images) * 255.0), 0, 255).astype(np.uint8)


def lora_targets(pipe):
    """[(module path in a diffusers LoRA file, namespace, port key)] of every
    attention projection of the UNet (to_q, to_k, to_v, to_out of attn1 and
    attn2) and of CLIP (q_proj, k_proj, v_proj, out_proj)."""
    from prompt_diffusion_tpu_torch.tools.diffusers_import import diffusers_unet_rules
    from prompt_diffusion_tpu_torch.tools.torch_import import rule_keys

    unet_keys = set(pipe.unet.state_dict())
    out = [("unet." + ref[:-len(".weight")], "unet", key)
           for ref, key in rule_keys(diffusers_unet_rules(pipe.unet.config))
           if ref.endswith(".weight") and key in unet_keys
           and any(f".attn{a}.{p}." in f".{key}" for a in "12"
                   for p in ("to_q", "to_k", "to_v", "to_out"))]
    for i in range(pipe.text_encoder.config.num_layers):
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out.append((f"text_encoder.text_model.encoder.layers.{i}.self_attn.{p}", "clip",
                        f"layers_{i}.self_attn.{p}.weight"))
    return out


def state_dicts_equal(tag, got, want):
    """Every tensor of {namespace: state dict} `got` equals `want`'s: the
    same keys, dtype, strides, device and values. Returns the count."""
    import torch

    n = 0
    for name, sd in want.items():
        check(set(got[name]) == set(sd), f"[{tag}] {name}: the keys differ")
        for key, t in sd.items():
            g = got[name][key]
            check(g.dtype == t.dtype and g.stride() == t.stride() and g.device == t.device
                  and torch.equal(g, t), f"[{tag}] {name}.{key} differs from its source")
            n += 1
    return n


def ckpt_sd15(pipe, img1, tmp):
    """The full-width SD1.5 round trips (`.ckpt`, then `.safetensors`) and
    the LoRA checks; returns (timing, the two file paths)."""
    import torch

    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15
    from prompt_diffusion_tpu_torch.tools import safetensors_io
    from prompt_diffusion_tpu_torch.tools.torch_import import export_ldm_checkpoint

    timing, files, kept = {}, {}, None
    src = pipe.state_dicts()
    r = sd15_request(0)
    gen = r.pop("generator")
    # [slice]'s x_T for request 1, drawn as `generate` draws it
    noise = torch.randn((REQ_BATCH, REQ_SIZE // 8, REQ_SIZE // 8, 4), generator=gen,
                        device="cuda", dtype=torch.float32)
    for fmt in ("ckpt", "safetensors"):
        path = files[fmt] = os.path.join(tmp, f"sd15.{fmt}")
        t = time.perf_counter()
        export_ldm_checkpoint(src, path, unet_cfg=pipe.unet.config,
                              vae_ch_mult=pipe.vae.config.ch_mult,
                              vae_num_res_blocks=pipe.vae.config.num_res_blocks,
                              clip_layers=pipe.text_encoder.config.num_layers)
        write_s = time.perf_counter() - t
        torch.cuda.synchronize()
        t = time.perf_counter()
        loaded = PromptDiffusionSD15.from_single_file(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        n = state_dicts_equal("ckpt", loaded.state_dicts(), src)
        t = time.perf_counter()
        img = loaded.generate(**r, init_noise=noise, num_steps=REQ_STEPS, guidance_scale=CFG)
        torch.cuda.synchronize()
        req_s = time.perf_counter() - t
        check(torch.equal(img, img1), f"[ckpt] request 1 through the .{fmt} file differs from "
                                      "[slice]'s")
        size = os.path.getsize(path)
        log(f"[ckpt] .{fmt}: {size} bytes ({size / 1e9:.3f} GB), written in {write_s:.2f}s, "
            f"loaded by from_single_file in {load_s:.2f}s; {n} tensors equal to the source "
            f"(dtype, strides, values); request 1 bit-equal to [slice]'s in {req_s:.3f}s")
        timing[fmt] = {"bytes": size, "write_s": write_s, "load_s": load_s, "request_s": req_s}
        if fmt == "ckpt":
            kept = loaded
        del loaded
    # LoRA: rank 4, peft layout, on every attention projection of the UNet and CLIP
    targets = lora_targets(kept)
    modules = kept.jax_modules()
    g = torch.Generator().manual_seed(7)
    lora = {}
    for mod, name, key in targets:
        out_f, in_f = modules[name].get_parameter(key).shape
        lora[f"{mod}.lora_A.weight"] = torch.randn(LORA_RANK, in_f, generator=g) * 0.05
        lora[f"{mod}.lora_B.weight"] = torch.randn(out_f, LORA_RANK, generator=g) * 0.05
    lora_path = os.path.join(tmp, "lora.safetensors")
    safetensors_io.save_file(lora, lora_path)
    before = {(name, key): modules[name].get_parameter(key).detach().cpu().clone()
              for _, name, key in targets}
    kept.load_lora_weights(lora_path, scale=0.0)
    img0 = kept.generate(**r, init_noise=noise, num_steps=REQ_STEPS, guidance_scale=CFG)
    check(torch.equal(img0, img1), "[ckpt] LoRA at scale 0 changed the image")
    torch.cuda.synchronize()
    t = time.perf_counter()
    folded = kept.load_lora_weights(lora_path, scale=1.0)
    torch.cuda.synchronize()
    fold_s = time.perf_counter() - t
    check(sum(map(len, folded.values())) == len(targets), f"[ckpt] LoRA folded {folded}")
    worst = worst_raw = 0.0
    dtypes = set()
    for mod, name, key in targets:
        w = modules[name].get_parameter(key).detach().cpu()
        ref = before[(name, key)].double() + (lora[f"{mod}.lora_B.weight"].double()
                                              @ lora[f"{mod}.lora_A.weight"].double())
        scale = ref.abs().max().item()
        rounded = ref.float().to(w.dtype).double()  # the fold's two roundings
        worst = max(worst, (w.double() - rounded).abs().max().item() / scale)
        worst_raw = max(worst_raw, (w.double() - ref).abs().max().item() / scale)
        dtypes.add(str(w.dtype).replace("torch.", ""))
    check(worst <= LORA_REL_BOUND, f"[ckpt] a fused weight is {worst} (relative) from "
                                   f"W + B.A rounded to its dtype")
    img_l = kept.generate(**r, init_noise=noise, num_steps=REQ_STEPS, guidance_scale=CFG)
    check(torch.isfinite(img_l).all().item() and not torch.equal(img_l, img1),
          "[ckpt] the LoRA at scale 1 gave a non-finite image or the base image")
    log(f"[ckpt] LoRA rank {LORA_RANK} (peft) on {len(targets)} projections "
        f"({len(folded['unet'])} UNet, {len(folded['clip'])} CLIP; weights {sorted(dtypes)}): "
        f"scale 0 bit-equal to the base image; scale 1 folded in {fold_s:.3f}s, each fused "
        f"weight within {worst} (relative to its largest value) of W + B.A computed in fp64 "
        f"on the host and rounded to the weight's dtype (bound {LORA_REL_BOUND}; before "
        f"that rounding {worst_raw}); the image finite and not the base image")
    timing["lora"] = {"projections": len(targets), "fold_s": fold_s, "max_rel": worst}
    return timing, files


def ckpt_serve(path, tmp):
    """`serve.main --ckpt` under the int8 policy; its PNGs against
    `SD15Adapter.execute` of the same requests on a pipeline loaded from
    the same file."""
    import gc

    import torch

    from prompt_diffusion_tpu_torch import serve
    from prompt_diffusion_tpu_torch.data.tokenizer import HashTokenizer
    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15
    from prompt_diffusion_tpu_torch.serving import SD15Adapter
    from prompt_diffusion_tpu_torch.utils.dtypes import int8_policy

    out = os.path.join(tmp, "served")
    t = time.perf_counter()
    rc = serve.main(["--ckpt", path, "--policy", "int8", "--steps", str(REQ_STEPS), "--demo",
                     "--out-dir", out])
    serve_s = time.perf_counter() - t
    check(rc == 0, f"[ckpt] serve.main returned {rc}")
    gc.collect()
    torch.cuda.empty_cache()
    pipe = PromptDiffusionSD15.from_single_file(path, policy=int8_policy(), vae_int8=True)
    tok = HashTokenizer()  # what serve.main's load_tokenizer(None) gives
    reqs = [serve.make_request(tok, p, i, REQ_SIZE, REQ_STEPS, "ddim", 7.0 + i)
            for i, p in enumerate(serve.DEMO_PROMPTS)]
    direct = to_png_values(SD15Adapter(pipe).execute(reqs).float().cpu().numpy())
    for i, want in enumerate(direct):
        got = read_png(os.path.join(out, f"req{i}.png"))
        check(got.shape == want.shape and (got == want).all(),
              f"[ckpt] served req{i}.png differs from SD15Adapter.execute on the loaded file")
    log(f"[ckpt] serve.main --ckpt --policy int8 --steps {REQ_STEPS} --demo: the whole entry "
        f"(load, warm-up, 4 requests, PNGs) in {serve_s:.2f}s; its {len(direct)} PNGs decode "
        f"to SD15Adapter.execute of the same requests on a pipeline loaded from the same file")
    return {"serve_main_s": serve_s}


def ckpt_generate(path, tmp):
    """The batch entry (`generate.main`, whole) on a COCO-layout data root
    of four 512² images made here, one batch of four at REQ_STEPS steps."""
    import numpy as np
    from PIL import Image

    from prompt_diffusion_tpu_torch import generate

    root, out = os.path.join(tmp, "coco"), os.path.join(tmp, "generated")
    rng = np.random.default_rng(11)
    names = [f"{i:012d}" for i in range(4)]
    for sub in ("images", "hed", "prompts"):
        os.makedirs(os.path.join(root, sub))
    for i, name in enumerate(names):
        for sub in ("images", "hed"):
            Image.fromarray(rng.integers(0, 256, (REQ_SIZE, REQ_SIZE, 3), dtype=np.uint8)).save(
                os.path.join(root, sub, f"{name}.jpg"))
        with open(os.path.join(root, "prompts", f"{name}.txt"), "w") as f:
            f.write(PROMPTS[i % len(PROMPTS)])
    t = time.perf_counter()
    rc = generate.main(["--stack", "sd15", "--ckpt", path, "--data-root", root, "--dataset",
                        "coco", "--tasks", "hed", "--steps", str(REQ_STEPS), "--batch-size", "4",
                        "--resolution", str(REQ_SIZE), "--out-dir", out])
    gen_s = time.perf_counter() - t
    check(rc == 0, f"[ckpt] generate.main returned {rc}")
    files = sorted(os.listdir(os.path.join(out, "hed")))
    check(files == [f"{n}.png" for n in names], f"[ckpt] generate wrote {files}")
    stds = []
    for f in files:
        img = read_png(os.path.join(out, "hed", f))
        check(img.shape == (REQ_SIZE, REQ_SIZE, 3), f"[ckpt] {f}: shape {img.shape}")
        stds.append(float(img.std()))
    log(f"[ckpt] generate.main (whole: PIL decode of the data root, from_single_file of the "
        f".safetensors file, one batch of 4 at {REQ_STEPS} DDIM steps): {gen_s:.2f}s; wrote "
        f"{len(files)} PNGs under hed/ (std of their values {[round(s, 2) for s in stds]})")
    return {"generate_main_s": gen_s}


def ckpt_sd3(tmp, seed=0):
    """An SD3 folder at full width and reduced depth (SD3_CKPT_LAYERS
    MMDiT, ControlNet and T5 layers) written from a random pipeline by the
    port's exporters, loaded by `PromptDiffusionSD3.from_folder` under the
    int8 policy; equal state dicts and a bit-equal request (T5 staged on
    the loaded pipeline, in-graph on the source)."""
    import torch

    from prompt_diffusion_tpu_torch.models.controlnet_sd3 import SD3ControlNet
    from prompt_diffusion_tpu_torch.models.mmdit_sd3 import MMDiTConfig, SD3Transformer
    from prompt_diffusion_tpu_torch.models.t5_text import T5Config, T5Encoder
    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd3 import PromptDiffusionSD3
    from prompt_diffusion_tpu_torch.tools.diffusers_import import export_sd3_folder
    from prompt_diffusion_tpu_torch.utils.dtypes import int8_policy, random_init_

    pol, depth = int8_policy(), SD3_CKPT_LAYERS

    def models(device):
        with torch.device(device):
            return dict(transformer=SD3Transformer(MMDiTConfig(num_layers=depth), pol),
                        controlnet=SD3ControlNet(MMDiTConfig(num_layers=depth), pol))

    with torch.device("cuda"):
        t5 = T5Encoder(T5Config(num_layers=depth))
    src = PromptDiffusionSD3.create(**models("cuda"), t5=t5, policy=pol, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for m in src.jax_modules().values():
        random_init_(m, gen)
    n_params = sum(p.numel() for m in src.jax_modules().values() for p in m.parameters())
    root = os.path.join(tmp, "sd3")
    torch.cuda.synchronize()
    t = time.perf_counter()
    export_sd3_folder({n: m.state_dict() for n, m in src.jax_modules().items()}, root,
                      num_layers=depth, controlnet_layers=depth)
    write_s = time.perf_counter() - t
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
    t = time.perf_counter()
    pipe = PromptDiffusionSD3.from_folder(root, policy=pol, t5=True, **models("meta"))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    n = state_dicts_equal("ckpt", {k: m.state_dict() for k, m in pipe.jax_modules().items()},
                          {k: m.state_dict() for k, m in src.jax_modules().items()})
    g = torch.Generator(device="cuda").manual_seed(1000)
    img = lambda: torch.rand((SD3_BATCH, SD3_SIZE, SD3_SIZE, 3), generator=g,
                             device="cuda") * 2 - 1
    t5_ids = [torch.randint(0, t5.config.vocab_size, (SD3_BATCH, T5_LEN), generator=g,
                            device="cuda") for _ in range(2)]
    ids = torch.from_numpy(hash_token_ids([PROMPTS[0]] * SD3_BATCH))
    neg = torch.from_numpy(hash_token_ids([""] * SD3_BATCH))
    args = dict(control_image=img(), support_cond=img(), support_image=img(),
                num_steps=SD3_CKPT_STEPS, guidance_scale=SD3_CFG, shift=SD3_SHIFT)
    want = src.generate(dict(l=ids, g=ids, t5=t5_ids[0]), dict(l=neg, g=neg, t5=t5_ids[1]),
                        **args, generator=torch.Generator(device="cuda").manual_seed(2000))
    del src, t5
    torch.cuda.empty_cache()
    t = time.perf_counter()
    seq, neg_seq = pipe.stage_t5(*t5_ids)
    got = pipe.generate(dict(l=ids, g=ids), dict(l=neg, g=neg), **args, t5_seq=seq,
                        neg_t5_seq=neg_seq,
                        generator=torch.Generator(device="cuda").manual_seed(2000))
    torch.cuda.synchronize()
    req_s = time.perf_counter() - t
    check(tuple(got.shape) == (SD3_BATCH, SD3_SIZE, SD3_SIZE, 3)
          and torch.isfinite(got).all().item(), "[ckpt] SD3 image shape or values")
    check(torch.equal(got, want), "[ckpt] the SD3 request on the loaded folder differs from "
                                  "the source pipeline's")
    log(f"[ckpt] SD3 folder (full width; {depth} MMDiT, {depth} ControlNet and {depth} T5 "
        f"layers; {n_params} parameters, int8 policy): {size} bytes ({size / 1e9:.3f} GB) "
        f"written in {write_s:.2f}s, loaded by from_folder in {load_s:.2f}s; {n} tensors "
        f"equal to the source; one {SD3_SIZE}² request at {SD3_CKPT_STEPS} steps (T5 staged) "
        f"bit-equal to the source pipeline's (in-graph T5) in {req_s:.3f}s")
    return {"bytes": size, "write_s": write_s, "load_s": load_s, "request_s": req_s,
            "parameters": n_params}


def phase_ckpt(pipe, img1, card):
    """Reference checkpoints into the port at full width, on files written
    under CKPT_DIR and deleted at the end: the SD1.5 `.ckpt` and
    `.safetensors` round trips of [slice]'s pipeline, a LoRA fused into a
    loaded pipeline, `serve.main --ckpt` under int8, the batch `generate`
    entry, and a reduced-depth SD3 folder; then `[notebook]` on the `.ckpt`.
    Returns {"ckpt": (launches, timing), "notebook": (launches, timing)}."""
    import shutil

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)
    t0 = time.perf_counter()
    try:
        counted = reset_launches()
        timing, files = ckpt_sd15(pipe, img1, CKPT_DIR)
        timing.update(ckpt_serve(files["ckpt"], CKPT_DIR))
        timing.update(ckpt_generate(files["safetensors"], CKPT_DIR))
        timing["sd3"] = ckpt_sd3(CKPT_DIR)
        launches = read_launches(counted)
        timing["phase_s"] = time.perf_counter() - t0
        notebook = phase_notebook(files["ckpt"], card)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    log(f"[ckpt] {card}: the phase in {timing['phase_s']:.1f}s; launches {launches}")
    for name in PATH_KERNELS["ckpt"]:
        check(launches[name] > 0, f"kernel {name} was not launched on the ckpt path")
    return {"ckpt": (launches, timing), "notebook": notebook}



def sd3_block_checks(pipe, seed=4100):
    """One quantized block of each SD3 kind (an MMDiT JointBlock, the
    context_pre_only last block, a ControlNet block) at the joint shape,
    the same seeded input through the kernels and through the plain ops:
    relative L2 over both output streams within EPS_REL_BOUND."""
    import torch

    from prompt_diffusion_tpu_torch.ops.dispatch import plain_ops

    g = torch.Generator(device="cuda").manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
    b, dim = 2 * SD3_BATCH, pipe.transformer.config.hidden_size
    n_img = (SD3_SIZE // 8 // pipe.transformer.config.patch_size) ** 2
    args = (randn(b, n_img, dim), randn(b, 77 + T5_LEN, dim), randn(b, dim))
    last = pipe.transformer.config.num_layers - 1
    blocks = {"MMDiT JointBlock 0": pipe.transformer.blocks_0,
              f"MMDiT JointBlock {last} (context_pre_only)": getattr(pipe.transformer,
                                                                     f"blocks_{last}"),
              "ControlNet JointBlock 0": pipe.controlnet.blocks_0}
    flat = lambda outs: torch.cat([o.float().flatten() for o in outs if o is not None])
    with torch.no_grad():
        for name, module in blocks.items():
            out = flat(module(*args))
            with plain_ops():
                ref = flat(module(*args))
            err = ((out - ref).norm() / ref.norm()).item()
            log(f"[sd3] block {name} at ({b},{n_img}+{77 + T5_LEN},{dim}), kernels vs plain ops "
                f"on the same input: rel L2 {err} (bound {EPS_REL_BOUND})")
            check(err <= EPS_REL_BOUND, f"block {name}: rel L2 {err} > {EPS_REL_BOUND}")


def sd3_served(pipe):
    """One SD3 request at 2 steps through GenerationServer(adapter=
    SD3Adapter(pipe)), bit-equal to pipe.generate on the same inputs."""
    import numpy as np
    import torch

    from prompt_diffusion_tpu_torch.serving import (
        GenerationServer,
        SD3Adapter,
        SD3GenerationRequest,
        ServerConfig,
    )

    rng = np.random.default_rng(6100)
    img = lambda: rng.uniform(-1, 1, (SD3_SIZE, SD3_SIZE, 3)).astype(np.float32)
    ids, neg = hash_token_ids([PROMPTS[0]])[0], hash_token_ids([""])[0]
    req = SD3GenerationRequest(token_ids_l=ids, token_ids_g=ids, neg_ids_l=neg, neg_ids_g=neg,
                               support_cond=img(), support_image=img(), query=img(),
                               num_steps=2, guidance_scale=SD3_CFG, shift=SD3_SHIFT, seed=6101)
    adapter = SD3Adapter(pipe)
    t = time.perf_counter()
    with GenerationServer(pipe, ServerConfig(max_batch=1), adapter=adapter) as server:
        served = server.generate(req, timeout=600)
    s = time.perf_counter() - t
    with torch.no_grad():
        ref = pipe.generate(**adapter.inputs([req]))[0].cpu().numpy()
    log(f"[sd3] one request (2 steps) through GenerationServer(adapter=SD3Adapter): "
        f"{s:.3f}s; bit-equal to pipe.generate {np.array_equal(served, ref)}")
    check(np.array_equal(served, ref), "[sd3] the served image differs from pipe.generate's")


def phase_sd3(seed=0):
    """SD3 at full width in the int8 serving mode through the port's public
    API, with T5-XXL staged: the checks of the SD1.5 paths, each quantized
    block kind against the plain ops, and one CFG velocity evaluation
    (ControlNet + MMDiT at the first timestep) against the plain ops and
    an fp32-compute int8 evaluation of the same weights."""
    import dataclasses

    import numpy as np
    import torch

    from prompt_diffusion_tpu_torch.models.controlnet_sd3 import SD3ControlNet
    from prompt_diffusion_tpu_torch.models.mmdit_sd3 import SD3Transformer
    from prompt_diffusion_tpu_torch.models.t5_text import T5Encoder
    from prompt_diffusion_tpu_torch.ops.dispatch import plain_ops
    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd3 import PromptDiffusionSD3
    from prompt_diffusion_tpu_torch.schedulers.flow_match import make_inference_sigmas
    from prompt_diffusion_tpu_torch.tools.timing import time_ms
    from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy, int8_policy, random_init_

    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    # staged T5, as bench.py runs it: encode the prompts, free the encoder
    with torch.device("cuda"):
        t5 = T5Encoder()
    random_init_(t5.eval().requires_grad_(False), gen)
    n_t5 = sum(p.numel() for p in t5.parameters())
    ids_gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    t5_ids = [torch.randint(0, t5.config.vocab_size, (SD3_BATCH, T5_LEN), generator=ids_gen,
                            device="cuda") for _ in range(3)]  # request 1, request 2, negative
    PromptDiffusionSD3.encode_t5(t5, t5_ids[0])  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    t5_seqs = [PromptDiffusionSD3.encode_t5(t5, ids) for ids in t5_ids]
    torch.cuda.synchronize()
    t5_ms = (time.perf_counter() - t) * 1e3 / len(t5_ids)
    del t5
    torch.cuda.empty_cache()
    pipe = PromptDiffusionSD3.create(policy=int8_policy(), device="cuda")
    models = (pipe.transformer, pipe.controlnet, pipe.down_proj, pipe.vae, pipe.clip_l,
              pipe.clip_g)
    for m in models:
        random_init_(m, gen)
    torch.cuda.synchronize()
    n_params = n_t5 + sum(p.numel() for m in models for p in m.parameters())
    log(f"[sd3] SD3 built with random weights: {n_params} parameters (T5-XXL {n_t5}, staged: "
        f"{t5_ms:.1f} ms per prompt encode at L={T5_LEN}, then freed) in "
        f"{time.perf_counter() - t0:.1f}s")
    check(all(torch.isfinite(t).all().item() for t in t5_seqs), "non-finite T5 states")

    def request(i):
        g = torch.Generator(device="cuda").manual_seed(1000 + i)
        img = lambda: torch.rand((SD3_BATCH, SD3_SIZE, SD3_SIZE, 3), generator=g,
                                 device="cuda") * 2 - 1
        ids = torch.from_numpy(hash_token_ids([PROMPTS[i]] * SD3_BATCH))
        neg = torch.from_numpy(hash_token_ids([""] * SD3_BATCH))
        return dict(prompt_ids=dict(l=ids, g=ids), neg_prompt_ids=dict(l=neg, g=neg),
                    control_image=img(), support_cond=img(), support_image=img(),
                    t5_seq=t5_seqs[i], neg_t5_seq=t5_seqs[2],
                    generator=torch.Generator(device="cuda").manual_seed(2000 + i))

    def answer(i):
        t = time.perf_counter()
        img = pipe.generate(**request(i), num_steps=SD3_STEPS, guidance_scale=SD3_CFG,
                            shift=SD3_SHIFT)
        torch.cuda.synchronize()
        return img, time.perf_counter() - t

    counted = reset_launches()
    img1, s1 = answer(0)
    img2, s2 = answer(1)
    launches = {name: w.launches for name, w in counted.items()}
    per_step = {name: launches[name] / (2 * SD3_STEPS) for name in PATH_KERNELS["sd3"]}
    log(f"[sd3] request 1: {s1:.3f}s, request 2: {s2:.3f}s; launches {launches}; per denoise "
        f"step (VAE launches spread over the steps) {per_step}")
    for name in PATH_KERNELS["sd3"]:
        check(launches[name] > 0, f"kernel {name} was not launched on the sd3 path")
    check(launches["quant_k_int8"] == launches["flash_attention_packed_int8"],
          "K9's prologue did not run once per K9 call")
    for img in (img1, img2):
        check(tuple(img.shape) == (SD3_BATCH, SD3_SIZE, SD3_SIZE, 3), f"shape {tuple(img.shape)}")
        check(torch.isfinite(img).all().item(), "non-finite image")
        check(img.min().item() >= 0.0 and img.max().item() <= 1.0, "image outside [0, 1]")
    check(not torch.equal(img1, img2), "the two requests gave the same images")
    img1b, s1b = answer(0)
    check(torch.equal(img1, img1b), "request 1 with the same generator gave other images")
    log(f"[sd3] images {tuple(img1.shape)} finite in [0,1]; requests differ; request 1 "
        f"repeated bit-exactly in {s1b:.3f}s; std {img1.float().std().item():.4f}")
    (img1c, _), again = one_launch_per_call("sd3", lambda: answer(0))
    check(torch.equal(img1, img1c), "request 1 under the profiler gave other images")
    for name in PATH_ONE_LAUNCH:
        check(2 * again[name] == launches[name],
              f"[sd3] {name}: {again[name]} calls in request 1, {launches[name]} in two")

    sd3_served(pipe)
    sd3_block_checks(pipe)

    # one CFG velocity evaluation (ControlNet + MMDiT at the first timestep):
    # guidance 0 and 1 give the uncond and cond outputs; kernels, plain ops,
    # and an fp32-compute int8 twin of the same weights on the plain ops,
    # all three on the same encodings (made by the kernels, one generator seed)
    r = request(0)
    r.pop("generator")
    vel = lambda p, gs: p.make_velocity_fn(
        **r, guidance_scale=gs, generator=torch.Generator(device="cuda").manual_seed(2000))
    g = torch.Generator(device="cuda").manual_seed(3000)
    x = torch.randn((SD3_BATCH, pipe.vae.config.z_channels, SD3_SIZE // 8, SD3_SIZE // 8),
                    generator=g, device="cuda")
    timesteps, _ = make_inference_sigmas(SD3_STEPS, shift=SD3_SHIFT)
    t = torch.full((SD3_BATCH,), float(np.float32(timesteps[0])), device="cuda")
    gs_all = (0.0, 1.0, SD3_CFG)
    with torch.no_grad():
        fns = {gs: vel(pipe, gs) for gs in gs_all}
        kern = {gs: f(x, t) for gs, f in fns.items()}
        step_s = time_ms(lambda: fns[SD3_CFG](x, t), iters=3, warmup=1) / 1e3
        f32 = DTypePolicy(compute_dtype=torch.float32, quant="int8")
        with torch.device("cuda"):
            twin = dataclasses.replace(pipe, transformer=SD3Transformer(policy=f32).eval(),
                                       controlnet=SD3ControlNet(policy=f32).eval())
        twin.transformer.load_state_dict(pipe.transformer.state_dict())
        twin.controlnet.load_state_dict(pipe.controlnet.state_dict())
        twin_fns = {gs: vel(twin, gs) for gs in gs_all}
        with plain_ops():
            plain = {gs: f(x, t) for gs, f in fns.items()}
            ref = {gs: f(x, t) for gs, f in twin_fns.items()}
        del fns, twin_fns, twin
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    branches = lambda v: torch.cat([v[0.0], v[1.0]])
    rel_k32, rel_p32 = rel(branches(kern), branches(ref)), rel(branches(plain), branches(ref))
    rel_gk32, rel_gp32 = rel(kern[SD3_CFG], ref[SD3_CFG]), rel(plain[SD3_CFG], ref[SD3_CFG])
    log(f"[sd3] velocity (t={float(timesteps[0]):.2f}), kernels vs plain ops: rel L2 "
        f"{rel(branches(kern), branches(plain))} over the uncond and cond outputs, guided "
        f"(CFG {SD3_CFG}) {rel(kern[SD3_CFG], plain[SD3_CFG])}")
    log(f"[sd3] against an fp32-compute int8 evaluation of the same weights on the plain ops: "
        f"unguided kernels {rel_k32}, plain ops {rel_p32}; guided kernels {rel_gk32}, plain ops "
        f"{rel_gp32} (bound {FP32_RATIO_BOUND}x the plain ops')")
    check(np.isfinite(rel_k32) and rel_k32 <= FP32_RATIO_BOUND * rel_p32,
          f"unguided velocity: kernels {rel_k32} vs plain {rel_p32} from the fp32 evaluation")
    check(rel_gk32 <= FP32_RATIO_BOUND * rel_gp32,
          f"guided velocity: kernels {rel_gk32} vs plain {rel_gp32} from the fp32 evaluation")
    del pipe
    torch.cuda.empty_cache()
    return launches, {"request_s": [s1, s2, s1b], "step_s": step_s, "t5_ms": t5_ms,
                      "per_step": per_step}


def phase_adaln(seed=5000):
    """K12, which no model calls, on the path a training step of an AdaLN
    site takes: the forward kernel, then the backward kernel through
    autograd, at the SD3 image and context streams (per-sample modulation
    as (B, C) and (B, 1, C)); each call under the profiler one launch of
    each kernel and none of the parent Triton program
    (`one_launch_per_call`); outputs and gradients finite and of the
    inputs' shapes."""
    import torch

    from prompt_diffusion_tpu_torch.ops.fused_adaln import fused_adaln

    g = torch.Generator(device="cuda").manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
    launches = {}
    t0 = time.perf_counter()
    for b, n, c in ((2, 4096, 1536), (2, 333, 1536)):
        x = randn(b, n, c).requires_grad_()
        scale, shift = (0.1 * randn(b, c)).requires_grad_(), (0.1 * randn(b, 1, c)).requires_grad_()

        def step():
            for t in (x, scale, shift):
                t.grad = None
            out = fused_adaln(x, scale, shift)
            out.float().square().sum().backward()
            return out

        out, per_call = one_launch_per_call("adaln", step)
        check(per_call["fused_adaln"] == 1 and per_call["fused_adaln_bwd"] == 1,
              f"AdaLN at {(b, n, c)}: {per_call['fused_adaln']} forward and "
              f"{per_call['fused_adaln_bwd']} backward launches in one call")
        for name, count in per_call.items():
            launches[name] = launches.get(name, 0) + count
        check(out.shape == x.shape and out.dtype == x.dtype and torch.isfinite(out).all().item(),
              f"AdaLN at {(b, n, c)}: output {tuple(out.shape)} {out.dtype}")
        for name, t in (("x", x), ("scale", scale), ("shift", shift)):
            check(t.grad is not None and t.grad.shape == t.shape and t.grad.dtype == t.dtype
                  and torch.isfinite(t.grad).all().item(), f"AdaLN at {(b, n, c)}: grad of {name}")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    log(f"[adaln] forward + backward at (2,4096,1536) and (2,333,1536) bf16: outputs and "
        f"gradients finite, of the inputs' shapes and dtypes, in {seconds:.3f}s (under the "
        f"profiler); launches {dict((k, launches[k]) for k in PATH_KERNELS['adaln'])}")
    for name in PATH_KERNELS["adaln"]:
        check(launches[name] > 0, f"kernel {name} was not launched on the adaln path")
    return launches, {"seconds": seconds}


def phase_labs():
    """The attention lab entry point at LAB_ITERS timed iterations per
    variant: every variant within ATTN_REL_BOUND of its largest plain
    output."""
    from prompt_diffusion_tpu_torch.tools import attn_lab

    counted = reset_launches()
    t0 = time.perf_counter()
    rows = [row for lab_rows in attn_lab.run(iters=LAB_ITERS).values() for row in lab_rows]
    seconds = time.perf_counter() - t0
    launches = {name: w.launches for name, w in counted.items()}
    log(f"[labs] {len(rows)} variants in {seconds:.1f}s; launches "
        f"{ {k: launches[k] for k in PATH_KERNELS['labs']} }")
    for row in rows:
        check(row["err_over_max"] <= ATTN_REL_BOUND,
              f"lab variant {row['variant']}: error {row['err_over_max']} of its largest output")
    for name in PATH_KERNELS["labs"]:
        check(launches[name] > 0, f"kernel {name} was not launched on the labs path")
    return launches, {"seconds": seconds}


def _check_per_forward(tag, launches, forwards):
    """The launches of `tag`'s kernels are PER_FORWARD's per forward."""
    for name, per in PER_FORWARD[tag].items():
        check(launches[name] == per * forwards,
              f"[{tag}] {name}: {launches[name]} launches in {forwards} forwards, expected "
              f"{per} per forward")


def phase_midas(card, seed=0):
    """The MiDaS DPT-Hybrid depth + normal annotator at full width through
    the port's modules, on MIDAS_BATCHES batches of MIDAS_BATCH uniform
    [0, 255] images at MIDAS_SIZE² (`bench.py --config annotate --annotator
    midas`), bf16 and then int8; one DPT-Large forward. Returns ({path tag:
    (launches, timing)}, the bf16 DPT-Hybrid, the image batches)."""
    import numpy as np
    import torch

    from prompt_diffusion_tpu_torch.annotators.midas import (
        DPTDepth,
        DPTHybridDepth,
        depth_to_normals,
    )
    from prompt_diffusion_tpu_torch.ops.dispatch import plain_ops
    from prompt_diffusion_tpu_torch.utils.dtypes import (
        default_policy,
        fp32_policy,
        int8_policy,
        random_init_,
    )

    def build(cls, policy, state=None):
        with torch.device("cuda"):
            model = cls(policy=policy).eval().requires_grad_(False)
        if state is None:
            random_init_(model, torch.Generator(device="cuda").manual_seed(seed))
        else:
            model.load_state_dict(state)
        return model

    def annotate(model, imgs):
        """(depth, depth01, normals, seconds) of one batch, as bench.py."""
        t = time.perf_counter()
        depth = model(imgs.permute(0, 3, 1, 2) / 127.5 - 1.0)
        d01, normals = depth_to_normals(depth)
        torch.cuda.synchronize()
        return depth, d01, normals, time.perf_counter() - t

    rel = lambda a, b: ((a.float() - b.float()).norm() / b.float().norm()).item()
    g = torch.Generator(device="cuda").manual_seed(seed + 6000)
    batches = [torch.rand((MIDAS_BATCH, MIDAS_SIZE, MIDAS_SIZE, 3), generator=g,
                          device="cuda") * 255 for _ in range(MIDAS_BATCHES)]
    paths = {}
    t0 = time.perf_counter()
    model = build(DPTHybridDepth, default_policy())
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[midas] DPT-Hybrid built with random weights: {n_params} parameters in "
        f"{time.perf_counter() - t0:.1f}s")
    with torch.no_grad():
        for tag, policy in (("midas", None), ("midas_int8", int8_policy())):
            m = model if policy is None else build(DPTHybridDepth, policy, model.state_dict())
            annotate(m, batches[0])  # warm-up: cuDNN's algorithm choice
            torch.cuda.reset_peak_memory_stats()
            counted = reset_launches()
            outs = [annotate(m, imgs) for imgs in batches]
            launches = read_launches(counted)
            peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
            seconds = [o[3] for o in outs]
            log(f"[{tag}] {card}: {seconds[-1]:.4f} s per batch of {MIDAS_BATCH} at "
                f"{MIDAS_SIZE}² ({MIDAS_BATCH / seconds[-1]:.2f} images/s; first batch "
                f"{seconds[0]:.4f} s); peak device memory {peak_gib:.2f} GiB; launches "
                f"{ {k: launches[k] for k in MIDAS_PER_FORWARD[tag]} }")
            _check_per_forward(tag, launches, MIDAS_BATCHES)
            _, again = one_launch_per_call(tag, lambda: annotate(m, batches[0]))
            _check_per_forward(tag, again, 1)
            for depth, d01, normals, _ in outs:
                check(tuple(depth.shape) == (MIDAS_BATCH, MIDAS_SIZE, MIDAS_SIZE)
                      and tuple(normals.shape) == (MIDAS_BATCH, MIDAS_SIZE, MIDAS_SIZE, 3),
                      f"[{tag}] shapes {tuple(depth.shape)}, {tuple(normals.shape)}")
                check(all(torch.isfinite(t).all().item() for t in (depth, d01, normals)),
                      f"[{tag}] non-finite output")
                check(all(t.min().item() >= 0.0 and t.max().item() <= 1.0 for t in (d01, normals)),
                      f"[{tag}] depth01 or normals outside [0, 1]")
            depth = outs[0][0]
            check(not torch.equal(depth, outs[1][0]), f"[{tag}] the two batches gave one depth")
            check(torch.equal(depth, annotate(m, batches[0])[0]),
                  f"[{tag}] batch 1 repeated gave another depth")
            with plain_ops():
                plain = annotate(m, batches[0])[0]
            err = rel(depth, plain)
            timing = {"batch_s": seconds, "images_s": MIDAS_BATCH / seconds[-1],
                      "peak_gib": peak_gib}
            if tag == "midas":
                twin = build(DPTHybridDepth, fp32_policy(), model.state_dict())
                with plain_ops():
                    ref32 = annotate(twin, batches[0])[0]
                del twin
                rel_k32, rel_p32 = rel(depth, ref32), rel(plain, ref32)
                log(f"[midas] raw depth of batch 1, kernels vs plain ops: rel L2 {err} (bound "
                    f"{EPS_REL_BOUND}); against an fp32-compute twin on the plain ops: kernels "
                    f"{rel_k32}, plain ops {rel_p32} (bound {FP32_RATIO_BOUND}x the plain ops'); "
                    f"batch 1 repeated bit-exactly; depth std {depth.std().item():.4g}, "
                    f"{(depth > 0).float().mean().item():.3f} of pixels > 0")
                check(np.isfinite(err) and err <= EPS_REL_BOUND, f"[midas] rel L2 {err}")
                check(rel_k32 <= FP32_RATIO_BOUND * rel_p32,
                      f"[midas] kernels {rel_k32} vs plain {rel_p32} from the fp32 twin")
                bf16_depth = depth
            else:
                x = (torch.randn((MIDAS_BATCH, (MIDAS_SIZE // 16) ** 2 + 1, 768), generator=g,
                                 device="cuda")).to(torch.bfloat16)
                blk = m.blocks_0(x)
                with plain_ops():
                    blk_plain = m.blocks_0(x)
                blk_err = rel(blk, blk_plain)
                log(f"[midas_int8] int8 ViT block 0 at {tuple(x.shape)}, kernels vs plain ops on "
                    f"the same input: rel L2 {blk_err} (bound {EPS_REL_BOUND}); raw depth vs "
                    f"plain ops {err}, vs the bf16 policy's {rel(depth, bf16_depth)} (for "
                    f"information); batch 1 repeated bit-exactly")
                check(blk_err <= EPS_REL_BOUND, f"[midas_int8] block rel L2 {blk_err}")
                del m
            paths[tag] = (launches, timing)

        # DPT-Large: 16 heads, the transposed convs
        large = build(DPTDepth, default_policy())
        imgs = batches[0][:2]
        annotate(large, imgs)
        counted = reset_launches()
        depth, d01, normals, s_large = annotate(large, imgs)
        launches = read_launches(counted)
        _check_per_forward("midas_large", launches, 1)
        with plain_ops():
            plain = annotate(large, imgs)[0]
            twin = build(DPTDepth, fp32_policy(), large.state_dict())
            ref32 = annotate(twin, imgs)[0]
        del twin
        err, rel_k32, rel_p32 = rel(depth, plain), rel(depth, ref32), rel(plain, ref32)
        log(f"[midas_large] DPT-Large ({sum(p.numel() for p in large.parameters())} parameters) "
            f"batch 2 at {MIDAS_SIZE}²: {s_large:.4f} s; raw depth vs plain ops rel L2 {err} "
            f"(bound {EPS_REL_BOUND}); against an fp32-compute twin on the plain ops: kernels "
            f"{rel_k32}, plain ops {rel_p32} (bound {FP32_RATIO_BOUND}x the plain ops'); launches "
            f"{ {k: launches[k] for k in MIDAS_PER_FORWARD['midas_large']} }")
        check(all(torch.isfinite(t).all().item() for t in (depth, d01, normals)),
              "[midas_large] non-finite output")
        check(err <= EPS_REL_BOUND, f"[midas_large] rel L2 {err}")
        check(rel_k32 <= FP32_RATIO_BOUND * rel_p32,
              f"[midas_large] kernels {rel_k32} vs plain {rel_p32} from the fp32 twin")
        paths["midas_large"] = (launches, {"batch_s": s_large})
        del large

    return paths, model, batches


def fan_in_init_(module, gen, gain=2.0):
    """`random_init_`, then every tensor of 2 or more dimensions rescaled to
    N(0, gain / fan_in) (gain 2: He): under N(0, 0.02) HED's, M-LSD's and
    OpenPose's outputs vanish (stds ~3e-4, 2e-7 and 6e-6 at 512², fp32),
    since their ReLU convs have no norm or residual to hold the signal. HED
    takes gain 1: its input is RGB minus the mean (~±128), and under He its
    fused score saturates the sigmoid."""
    import math

    import torch

    from prompt_diffusion_tpu_torch.utils.dtypes import random_init_

    random_init_(module, gen)
    with torch.no_grad():
        for p in module.parameters():
            if p.ndim >= 2:
                p.mul_(math.sqrt(gain / p[0].numel()) / 0.02)
    return module


def run_annotator(tag, card, fn, batches, timing_extra=None):
    """One annotator as `bench.py --config annotate` times it: a warm-up
    batch, then each batch synchronised; prints images/s, the first batch's
    time, peak memory and the launches per forward, checked against
    PER_FORWARD (a tag without an entry launches no kernel of the port);
    `one_launch_per_call` on batch 1. Returns (outputs, launches, timing)."""
    import torch

    def timed(x):
        t = time.perf_counter()
        out = fn(x)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    first_s = timed(batches[0])[1]  # cuDNN's algorithm choice, Triton's compiles
    torch.cuda.reset_peak_memory_stats()
    counted = reset_launches()
    runs = [timed(x) for x in batches]
    launches = read_launches(counted)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    seconds = [r[1] for r in runs]
    n = batches[0].shape[0]
    shown = PER_FORWARD.get(tag, {k: 0 for k in ("flash_attention_packed", "fused_layer_norm",
                                                 "fused_group_norm")})
    log(f"[{tag}] {card}: {seconds[-1]:.4f} s per batch of {n} at {ANN_SIZE}² "
        f"({n / seconds[-1]:.2f} images/s; first batch {first_s:.4f} s, then "
        f"{[round(x, 4) for x in seconds]}); peak device memory {peak_gib:.2f} GiB; launches "
        f"per forward { {k: launches[k] / len(batches) for k in shown} }")
    if tag in PER_FORWARD:
        _check_per_forward(tag, launches, len(batches))
        _, again = one_launch_per_call(tag, lambda: fn(batches[0]))
        _check_per_forward(tag, again, 1)
    else:
        busy = {k: v for k, v in launches.items() if v}
        check(not busy, f"[{tag}] launched kernels of the port: {busy}")
    timing = {"batch_s": seconds, "first_batch_s": first_s, "images_s": n / seconds[-1],
              "peak_gib": peak_gib, **(timing_extra or {})}
    return [r[0] for r in runs], launches, timing


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _check_outputs(tag, outs, again, plain, shape, lo=None, hi=None):
    """Shapes, finite values (in [lo, hi] where given), two batches that
    differ, batch 1 repeated bit-exactly, and batch 1 against the plain ops
    (relative L2 within EPS_REL_BOUND); returns that distance."""
    import torch

    for o in outs:
        check(tuple(o.shape) == shape, f"[{tag}] shape {tuple(o.shape)}, expected {shape}")
        check(torch.isfinite(o).all().item(), f"[{tag}] non-finite output")
        if lo is not None:
            check(o.min().item() >= lo and o.max().item() <= hi, f"[{tag}] outside [{lo}, {hi}]")
    check(not torch.equal(outs[0], outs[1]), f"[{tag}] the two batches gave one output")
    check(torch.equal(outs[0], again), f"[{tag}] batch 1 repeated gave another output")
    err = _rel(outs[0], plain)
    check(err <= EPS_REL_BOUND, f"[{tag}] rel L2 {err} against the plain ops")
    return err


def phase_annotators(card, dpt, batches, midas_timing, seed=0):
    """HED, UniFormer-S/UperNet (bf16, then int8), M-LSD and OpenPose at full
    width (random weights from a seed) on ANN_BATCHES batches of ANN_BATCH
    uniform [0, 255] images at ANN_SIZE² (`bench.py --config annotate`);
    each against the plain ops; M-LSD's and OpenPose's detectors on 2
    images; the reference annotation pass (HED + UniFormer + MiDaS-Hybrid);
    the annotation entry's batch function with canny, hed, depth, normal and
    seg. Returns {path tag: (launches, timing)}."""
    import shutil

    import numpy as np
    import torch
    import torch.nn.functional as F

    from prompt_diffusion_tpu_torch.annotate_data import annotate_batch, build_annotators
    from prompt_diffusion_tpu_torch.annotators.hed import HEDNetwork
    from prompt_diffusion_tpu_torch.annotators.mlsd import MLSDdetector, MLSDNet
    from prompt_diffusion_tpu_torch.annotators.openpose import BodyPoseNet, OpenposeDetector
    from prompt_diffusion_tpu_torch.annotators.uniformer import UniFormerSeg
    from prompt_diffusion_tpu_torch.ops.dispatch import plain_ops
    from prompt_diffusion_tpu_torch.utils.dtypes import (
        default_policy,
        fp32_policy,
        int8_policy,
        random_init_,
    )

    gen = lambda k: torch.Generator(device="cuda").manual_seed(seed + k)

    def build(cls, policy, state=None, init=None, k=0):
        with torch.device("cuda"):
            model = cls(policy=policy).eval().requires_grad_(False)
        if state is not None:
            model.load_state_dict(state)
        else:
            (init or random_init_)(model, gen(k))
        return model

    nchw = lambda x: x.permute(0, 3, 1, 2)
    paths = {}
    with torch.no_grad():
        # HED: the entry's map, the edge probability x 255
        hed = build(HEDNetwork, default_policy(), init=lambda m, g: fan_in_init_(m, g, 1.0), k=1)
        hed_fn = lambda x: hed(nchw(x)) * 255.0
        outs, launches, timing = run_annotator("hed", card, hed_fn, batches)
        with plain_ops():
            plain = hed_fn(batches[0])
        err = _check_outputs("hed", outs, hed_fn(batches[0]), plain,
                             (ANN_BATCH, ANN_SIZE, ANN_SIZE), 0.0, 255.0)
        log(f"[hed] {sum(p.numel() for p in hed.parameters())} parameters; map of batch 1 vs "
            f"plain ops rel L2 {err} (bound {EPS_REL_BOUND}; no kernel of the port runs here); "
            f"batch 1 repeated bit-exactly; map mean {outs[0].mean().item():.4g}, std "
            f"{outs[0].std().item():.4g}, {(outs[0] > 127.5).float().mean().item():.3f} of "
            f"pixels above 127.5")
        paths["hed"] = (launches, timing)
        del outs, plain

        # UniFormer-S + UperNet: the entry's classes, bf16 then int8
        seg = build(UniFormerSeg, default_policy(), k=2)
        seg_fn = lambda x: seg(nchw(x)).argmax(dim=1)
        outs, launches, timing = run_annotator("seg", card, seg_fn, batches)
        check(all(tuple(o.shape) == (ANN_BATCH, ANN_SIZE, ANN_SIZE) for o in outs),
              "[seg] class map shape")
        check(not torch.equal(outs[0], outs[1]), "[seg] the two batches gave one class map")
        x0 = nchw(batches[0])
        logits = seg.head_logits(x0)
        check(torch.isfinite(logits).all().item(), "[seg] non-finite logits")
        check(torch.equal(logits, seg.head_logits(x0)), "[seg] batch 1 repeated gave other logits")
        with plain_ops():
            plain = seg.head_logits(x0)
        err = _rel(logits, plain)
        check(err <= EPS_REL_BOUND, f"[seg] logits rel L2 {err} against the plain ops")
        twin = build(UniFormerSeg, fp32_policy(), seg.state_dict())
        with plain_ops():
            ref32 = twin.head_logits(x0)
            cls32 = twin(x0).argmax(dim=1)
            cls_plain = seg(x0).argmax(dim=1)
        del twin
        flip_k = (outs[0] != cls32).float().mean().item()
        flip_p = (cls_plain != cls32).float().mean().item()
        # decision (a): the logits are upsampled in fp32; the JAX package's
        # bf16 upsample of the same logits, for comparison
        up = lambda t: F.interpolate(t, size=(ANN_SIZE, ANN_SIZE), mode="bilinear",
                                     align_corners=False)
        flip_bf16 = (up(logits.to(torch.bfloat16)).argmax(dim=1) != outs[0]).float().mean().item()
        log(f"[seg] {sum(p.numel() for p in seg.parameters())} parameters; quarter-size logits "
            f"of batch 1 vs plain ops rel L2 {err} (bound {EPS_REL_BOUND}), std "
            f"{logits.std().item():.4g} (N(0, 0.02) weights; against an fp32-compute twin "
            f"{_rel(logits, ref32)}); classes against the fp32 twin's: kernels {1 - flip_k} "
            f"agree, plain bf16 ops {1 - flip_p} (bound: the kernels' disagreement at most "
            f"{FP32_RATIO_BOUND}x the plain ops' + {SEG_FLIP_SLACK}); {len(outs[0].unique())} "
            f"classes present; the logits upsampled in bf16 (the JAX package) flip {flip_bf16} "
            f"of the pixels against the fp32 upsample")
        check(flip_k <= FP32_RATIO_BOUND * flip_p + SEG_FLIP_SLACK,
              f"[seg] kernels disagree with the fp32 twin on {flip_k} of the pixels, plain ops "
              f"on {flip_p}")
        timing.update(class_agree_fp32=1 - flip_k, plain_agree_fp32=1 - flip_p,
                      bf16_upsample_flips=flip_bf16, logits_std=logits.std().item())
        paths["seg"] = (launches, timing)
        bf16_cls = outs[0]
        del outs, plain, ref32

        seg8 = build(UniFormerSeg, int8_policy(), seg.state_dict())
        seg8_fn = lambda x: seg8(nchw(x)).argmax(dim=1)
        outs, launches, timing8 = run_annotator("seg_int8", card, seg8_fn, batches)
        logits8 = seg8.head_logits(x0)
        check(torch.isfinite(logits8).all().item(), "[seg_int8] non-finite logits")
        check(torch.equal(outs[0], seg8_fn(batches[0])), "[seg_int8] batch 1 repeated differs")
        with plain_ops():
            plain8 = seg8.head_logits(x0)
        blk = seg8.backbone.blocks3_0
        t = torch.randn((ANN_BATCH, 320, ANN_SIZE // 16, ANN_SIZE // 16), generator=gen(3),
                        device="cuda").to(torch.bfloat16).contiguous(
                            memory_format=torch.channels_last)
        got = blk(t)
        with plain_ops():
            blk_plain = blk(t)
        blk_err = _rel(got, blk_plain)
        log(f"[seg_int8] int8 SABlock 3.0 at {tuple(t.shape)}, kernels vs plain ops on the same "
            f"input: rel L2 {blk_err} (bound {EPS_REL_BOUND}); quarter-size logits vs plain ops "
            f"{_rel(logits8, plain8)}, vs the bf16 policy's {_rel(logits8, logits)} (for "
            f"information); classes equal to the bf16 policy's on "
            f"{(outs[0] == bf16_cls).float().mean().item()} of the pixels")
        check(blk_err <= EPS_REL_BOUND, f"[seg_int8] block rel L2 {blk_err}")
        paths["seg_int8"] = (launches, timing8)
        del seg8, outs, logits, logits8, plain8, bf16_cls

        # M-LSD: the net batched on the detector's input (RGB and ones)
        mlsd = build(MLSDNet, default_policy(), init=fan_in_init_, k=4)
        ones = torch.ones((ANN_BATCH, 1, ANN_SIZE, ANN_SIZE), device="cuda")
        mlsd_fn = lambda x: mlsd(torch.cat([nchw(x) / 127.5 - 1.0, ones], dim=1))
        outs, launches, timing = run_annotator("mlsd", card, mlsd_fn, batches)
        with plain_ops():
            plain = mlsd_fn(batches[0])
        err = _check_outputs("mlsd", outs, mlsd_fn(batches[0]), plain,
                             (ANN_BATCH, 9, ANN_SIZE // 2, ANN_SIZE // 2))
        rng = np.random.default_rng(seed)
        images = [rng.integers(0, 256, shape, dtype=np.uint8)
                  for shape in ((640, 576, 3), (384, 448, 3))]
        det = MLSDdetector(mlsd)
        det(images[0])
        t = time.perf_counter()
        maps = [det(img) for img in images]
        det_s = (time.perf_counter() - t) / len(images)
        check(all(m.shape == img.shape[:2] and m.dtype == np.uint8 for m, img in
                  zip(maps, images)), "[mlsd] detector map shapes")
        log(f"[mlsd] {sum(p.numel() for p in mlsd.parameters())} parameters; maps of batch 1 vs "
            f"plain ops rel L2 {err} (no kernel of the port runs here), std "
            f"{outs[0].std().item():.4g}; detector on {[i.shape for i in images]}: "
            f"{det_s:.4f} s per image (area resize, net, decode, raster on the host), "
            f"{[int((m > 0).sum()) for m in maps]} line pixels")
        timing["detector_s"] = det_s
        paths["mlsd"] = (launches, timing)
        del mlsd, outs, plain

        # OpenPose: the body net batched on BGR / 256 - 0.5
        body = build(BodyPoseNet, default_policy(), init=fan_in_init_, k=5)
        body_fn = lambda x: torch.cat(body(nchw(x).flip(1) / 256.0 - 0.5), dim=1)
        outs, launches, timing = run_annotator("openpose", card, body_fn, batches)
        with plain_ops():
            plain = body_fn(batches[0])
        err = _check_outputs("openpose", outs, body_fn(batches[0]), plain,
                             (ANN_BATCH, 57, ANN_SIZE // 8, ANN_SIZE // 8))
        # small images: under random weights every joint map peaks ~500 times
        # at 640 x 576 and the decode pairs every two peaks of a limb on the
        # host (~140 s an image); at 160 x 128 it stays ~20 a joint
        images = [rng.integers(0, 256, shape, dtype=np.uint8)
                  for shape in ((160, 128, 3), (128, 96, 3))]
        det = OpenposeDetector(body)
        det(images[1])
        t = time.perf_counter()
        poses = [det(img) for img in images]
        det_s = (time.perf_counter() - t) / len(images)
        check(all(c.shape == img.shape and c.dtype == np.uint8 for (c, _), img in
                  zip(poses, images)), "[openpose] detector canvas shapes")
        log(f"[openpose] {sum(p.numel() for p in body.parameters())} parameters; maps of batch 1 "
            f"vs plain ops rel L2 {err} (no kernel of the port runs here), PAF std "
            f"{outs[0][:, :38].std().item():.4g}, heat std {outs[0][:, 38:].std().item():.4g}; "
            f"detector on {[i.shape for i in images]}: {det_s:.4f} s per image; "
            f"{[len(info['candidate']) for _, info in poses]} candidates, "
            f"{[len(info['subset']) for _, info in poses]} people")
        timing["detector_s"] = det_s
        paths["openpose"] = (launches, timing)
        del body, outs, plain

        # the reference annotation pass, `bench.py --annotator pass`
        per_img = {name: 1.0 / paths[name][1]["images_s"] for name in ("hed", "seg")}
        per_img["midas"] = 1.0 / midas_timing["images_s"]
        pass_s = sum(per_img.values())
        log(f"[annotate] {card}: the annotation pass (hed + seg + depth/normal, bf16, batch "
            f"{ANN_BATCH} at {ANN_SIZE}²): {pass_s * 1e3:.3f} ms per image ({1.0 / pass_s:.2f} "
            f"images/s); per image: " + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in
                                                   per_img.items()))

        # the annotation entry's batch function, its files beside the sources
        out_dir = os.path.join(REPO, "build", "midas_annotate")
        shutil.rmtree(out_dir, ignore_errors=True)
        os.makedirs(out_dir)
        tasks = ("canny", "hed", "depth", "normal", "seg")
        fns = build_annotators(tasks, dpt=dpt, hed=hed, seg=seg)
        sources = [os.path.join(out_dir, f"image_{i}.jpg") for i in range(ANN_BATCH)]
        counted = reset_launches()
        t = time.perf_counter()
        written = annotate_batch(fns, sources, batches[0])
        s_entry = time.perf_counter() - t
        launches = read_launches(counted)
        check(len(written) == len(tasks) * ANN_BATCH and all(os.path.isfile(p) for p in written),
              f"[annotate] {len(written)} files written, expected {len(tasks) * ANN_BATCH}")
        for name in PATH_KERNELS["annotate"]:
            check(launches[name] > 0, f"kernel {name} was not launched on the annotate path")
        log(f"[annotate] {' + '.join(tasks)} of {ANN_BATCH} images at {ANN_SIZE}²: "
            f"{len(written)} files in {s_entry:.3f}s (jpg encoding included)")
        shutil.rmtree(out_dir)
        paths["annotate"] = (launches, {"seconds": s_entry, "pass_s": pass_s,
                                        "pass_images_s": 1.0 / pass_s, "per_image_s": per_img})
    del hed, seg
    torch.cuda.empty_cache()
    return paths


def _nonzero(launches):
    return {k: v for k, v in launches.items() if v}


def _expect(tag, launches, zero=()):
    """The path's kernels launched, and those of `zero` not."""
    for name in PATH_KERNELS[tag]:
        check(launches[name] > 0, f"kernel {name} was not launched on the {tag} path")
    for name in zero:
        check(launches[name] == 0, f"[{tag}] {name} launched {launches[name]} times")


def _quality(argv, tag, **pipes):
    """`tools.int8_quality.main` on the card, its JSON lines printed under
    the phase's tag; (its result, the launches of the run)."""
    import contextlib
    import io

    import numpy as np

    from prompt_diffusion_tpu_torch.tools import int8_quality

    counted = reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = int8_quality.main(argv + ["--device", "cuda"], **pipes)
    launches = read_launches(counted)
    for line in buf.getvalue().splitlines():
        log(f"[eval] {tag} quality: {line}")
    for mode, stats in out["timing"].items():
        log(f"[eval] {tag} {mode}: per batch (StepTimer, first batch left out) {stats}")
    imgs = out["images"]
    for mode, im in imgs.items():
        check(np.isfinite(im).all() and im.min() >= 0.0 and im.max() <= 1.0,
              f"[eval] {tag} {mode} images not finite in [0, 1]")
    check(not np.array_equal(imgs["bf16"], imgs["int8"]), f"[eval] {tag}: int8 equals bf16")
    return out, launches


def phase_eval(slice_pipe, slice_img1, card):
    """Evaluation on the card: `utils.config.create_model` on a full-width
    cldm_v15-format YAML (the names, shapes and dtypes of [slice]'s
    pipeline, whose weights it loads; request 1 bit-equal to [slice]'s);
    the Inception extractor at batch 64 (device ms, images/s, its features
    against the CPU's fp32 ones, a `utils.profiling.trace`); the int8
    quality protocol shortened for SD1.5 (the bench's int8 pipeline with
    the bf16 VAE) and SD3 (both policies), with a bf16 batch repeated bit
    for bit and the launches of each part; the FID and RMSE entries on the
    quality images written as PNGs. Returns {path tag: (launches, timing)}."""
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch

    from prompt_diffusion_tpu_torch.evaluation import fid, mse
    from prompt_diffusion_tpu_torch.evaluation.inception import (
        InceptionV3,
        create_inception,
        tf32_convolutions,
    )
    from prompt_diffusion_tpu_torch.serve import write_png
    from prompt_diffusion_tpu_torch.tools import int8_quality
    from prompt_diffusion_tpu_torch.tools.timing import device_kernels, device_ms, time_ms
    from prompt_diffusion_tpu_torch.utils import profiling
    from prompt_diffusion_tpu_torch.utils.config import create_model

    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    os.makedirs(EVAL_DIR)
    t_phase = time.perf_counter()
    paths = {}
    try:
        # ---- the config: a full-width YAML read by the port's own parser
        path = os.path.join(EVAL_DIR, "cldm_v15.yaml")
        with open(path, "w") as f:
            f.write(cldm_v15_yaml())
        t0 = time.perf_counter()
        pipe = create_model(path, device="cuda")
        build_s = time.perf_counter() - t0
        for name, m in pipe.jax_modules().items():
            want = slice_pipe.jax_modules()[name].state_dict()
            got = m.state_dict()
            check(list(got) == list(want), f"[eval] create_model's {name} names differ")
            for k, v in want.items():
                check(got[k].shape == v.shape and got[k].dtype == v.dtype,
                      f"[eval] create_model's {name}.{k}: {tuple(got[k].shape)} "
                      f"{got[k].dtype}, create()'s {tuple(v.shape)} {v.dtype}")
            m.load_state_dict(want)
        for k in ("betas", "alphas_cumprod"):
            check(np.array_equal(getattr(pipe.schedule, k), getattr(slice_pipe.schedule, k)),
                  f"[eval] create_model's schedule differs in {k}")
        counted = reset_launches()
        t0 = time.perf_counter()
        img = pipe.generate(**sd15_request(0), num_steps=REQ_STEPS, guidance_scale=CFG)
        torch.cuda.synchronize()
        req_s = time.perf_counter() - t0
        paths["eval_config"] = (read_launches(counted), {"build_s": build_s, "request_s": req_s})
        _expect("eval_config", paths["eval_config"][0])
        check(torch.equal(img, slice_img1), "[eval] create_model's request 1 differs from [slice]'s")
        log(f"[eval] create_model({os.path.basename(path)}): built in {build_s:.1f}s, every "
            f"state-dict name, shape and dtype equal to create()'s; with [slice]'s weights "
            f"request 1 bit-equal to [slice]'s ({req_s:.3f}s)")
        del pipe, img
        torch.cuda.empty_cache()

        # ---- the Inception extractor at batch 64, against fp32 on the CPU
        counted = reset_launches()
        model = create_inception(seed=0, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(7000)
        x = torch.rand((INCEPTION_BATCH, INCEPTION_SIZE, INCEPTION_SIZE, 3), generator=g,
                       device="cuda")
        with torch.inference_mode():
            feats = model(x)
            check(tuple(feats.shape) == (INCEPTION_BATCH, 2048), f"features {tuple(feats.shape)}")
            check(torch.isfinite(feats).all().item(), "[eval] non-finite Inception features")
            inc_ms = device_ms(lambda: model(x), iters=10, warmup=2)
            wall_ms = time_ms(lambda: model(x), iters=5, warmup=1)
            cpu = InceptionV3()
            cpu.load_state_dict(model.state_dict())
            cpu = cpu.to(memory_format=torch.channels_last).eval()
            sub = x[:INCEPTION_CPU_IMAGES]
            ref = cpu(sub.cpu())
            rel = lambda a: ((a.cpu() - ref).norm() / ref.norm()).item()
            rel_cpu = rel(feats[:INCEPTION_CPU_IMAGES])
            with tf32_convolutions():
                rel_tf32 = rel(model(sub))
            trace_dir = os.path.join(EVAL_DIR, "trace")
            with profiling.trace(trace_dir) as prof, profiling.annotate(INCEPTION_SPAN):
                model(x)
        # the device activities but the span's own annotation
        events = [e for e in device_kernels(prof) if e[0] != INCEPTION_SPAN]
        busy = {}  # device us by kernel name
        for name, start, end in events:
            busy[name] = busy.get(name, 0.0) + (end - start)
        kernels = set(busy)
        is_conv = lambda n: any(w in n.lower() for w in (
            "conv", "xmma", "implicit_gemm", "fprop", "winograd"))
        conv = sorted(n for n in kernels if is_conv(n))
        check(conv, f"[eval] the trace names no convolution kernel: {sorted(kernels)[:8]}")
        trace_path = os.path.join(trace_dir, profiling.TRACE_FILE)
        check(os.path.exists(trace_path), f"[eval] no trace at {trace_path}")
        with open(trace_path) as f:
            text = f.read()
        check(any(json.dumps(n)[1:-1] in text for n in conv),
              f"[eval] {trace_path} names no convolution kernel")
        total_us = sum(busy.values())
        top = sorted(busy.items(), key=lambda kv: -kv[1])[:5]
        images_s = INCEPTION_BATCH / (wall_ms / 1e3)
        log(f"[eval] Inception {card}: batch {INCEPTION_BATCH} at {INCEPTION_SIZE}² (resized "
            f"inside to 299²), fp32, TF32 off: {inc_ms:.3f} device ms per batch, {wall_ms:.3f} "
            f"ms per synchronised call, {images_s:.1f} images/s; features finite")
        log(f"[eval] Inception features against the CPU's fp32 ones ({INCEPTION_CPU_IMAGES} "
            f"images, same weights): rel L2 {rel_cpu} (bound {INCEPTION_CPU_REL_BOUND}); with "
            f"TF32 convolutions, for information: {rel_tf32}")
        log(f"[eval] trace {os.path.relpath(trace_path, REPO)}: {len(events)} kernel launches "
            f"of {len(kernels)} names, {len(conv)} of them convolutions; kernel time "
            f"{total_us / 1e3:.3f} ms, convolutions {sum(busy[n] for n in conv) / 1e3:.3f} ms; "
            f"the largest: " + "; ".join(f"{n[:60]} {us / 1e3:.3f} ms" for n, us in top))
        check(rel_cpu <= INCEPTION_CPU_REL_BOUND,
              f"[eval] Inception vs CPU fp32: {rel_cpu} > {INCEPTION_CPU_REL_BOUND}")
        fid_launches = read_launches(counted)
        del model, cpu, x, feats
        torch.cuda.empty_cache()

        # ---- the int8 quality protocol, shortened: SD1.5 with the bf16 VAE
        t0 = time.perf_counter()
        out, launches = _quality(EVAL_SD15, "sd15", bf16=slice_pipe)
        sd15_s = time.perf_counter() - t0
        paths["eval_sd15"] = (launches, {"phase_s": sd15_s, **out["timing"]})
        _expect("eval_sd15", launches)
        i8 = out["pipes"]["int8"]
        check(i8.vae is slice_pipe.vae and not any(
            type(m).__name__.startswith("Quant") for m in i8.vae.modules()),
            "[eval] the int8 SD1.5 pipeline does not hold the bf16 VAE")
        counted = reset_launches()
        again = int8_quality.generate_set("sd15", slice_pipe, EVAL_BATCH, EVAL_BATCH, REQ_SIZE,
                                          EVAL_STEPS, "bf16 again", profiling.StepTimer())
        paths["eval_sd15_bf16"] = (read_launches(counted), {})
        check(np.array_equal(again, out["images"]["bf16"][:EVAL_BATCH]),
              "[eval] sd15: a bf16 batch did not repeat bit for bit")
        g = torch.Generator(device="cuda").manual_seed(7100)
        lat = torch.randn((EVAL_BATCH, REQ_SIZE // 8, REQ_SIZE // 8, 4), generator=g,
                          device="cuda")
        counted = reset_launches()
        with torch.no_grad():
            i8.decode_latents(lat)
        paths["eval_decode"] = (read_launches(counted), {})
        quant = ("fused_group_norm_quant", "fused_layer_norm_quant", "fused_geglu_quant",
                 "conv3x3_int8")
        _expect("eval_sd15_bf16", paths["eval_sd15_bf16"][0], zero=quant)
        _expect("eval_decode", paths["eval_decode"][0], zero=quant + (
            "flash_attention_packed", "fused_layer_norm"))
        dec = paths["eval_decode"][0]
        check(dec["fused_group_norm"] == SD15_K3_PER_DECODE and dec["flash_attention"] == 1,
              f"[eval] one VAE decode: K3 {dec['fused_group_norm']} (expected "
              f"{SD15_K3_PER_DECODE}), K2 {dec['flash_attention']} (expected 1)")
        # the eps checks and the denoise steps
        evals = len(int8_quality.EPS_TIMESTEPS) + EVAL_N // EVAL_BATCH * EVAL_STEPS
        log(f"[eval] sd15 ({sd15_s:.1f}s): launches {_nonzero(launches)}; K5 per int8 ControlNet + UNet "
            f"evaluation {launches['fused_group_norm_quant'] / evals} ({evals} evaluations); "
            f"one decode of the int8 pipeline's bf16 VAE (batch {EVAL_BATCH}): K3 {dec['fused_group_norm']}"
            f", K2 {dec['flash_attention']}, K5 {dec['fused_group_norm_quant']}; a bf16 batch "
            f"repeated bit for bit")
        sets = {f"sd15_{mode}": im for mode, im in out["images"].items()}
        del out, i8
        torch.cuda.empty_cache()

        # ---- SD3 under both policies (no T5, as the JAX protocol runs it)
        t0 = time.perf_counter()
        out, launches = _quality(EVAL_SD3, "sd3")
        sd3_s = time.perf_counter() - t0
        paths["eval_sd3"] = (launches, {"phase_s": sd3_s, **out["timing"]})
        _expect("eval_sd3", launches)
        counted = reset_launches()
        again = int8_quality.generate_set("sd3", out["pipes"]["bf16"], 1, 1, SD3_SIZE,
                                          EVAL_SD3_STEPS, "bf16 again", profiling.StepTimer())
        paths["eval_sd3_bf16"] = (read_launches(counted), {})
        _expect("eval_sd3_bf16", paths["eval_sd3_bf16"][0], zero=(
            "flash_attention_packed_int8", "quant_k_int8", "fused_gelu_quant",
            "fused_quant_rows", "fused_adaln_quant"))
        check(np.array_equal(again, out["images"]["bf16"][:1]),
              "[eval] sd3: a bf16 batch did not repeat bit for bit")
        log(f"[eval] sd3 ({sd3_s:.1f}s, both pipelines built): launches {_nonzero(launches)}; "
            f"the bf16 policy's batch alone: {_nonzero(paths['eval_sd3_bf16'][0])}; repeated "
            f"bit for bit")
        sets.update({f"sd3_{mode}": im for mode, im in out["images"].items()})
        del out, again
        torch.cuda.empty_cache()

        # ---- the FID and RMSE entries on the quality images as PNGs
        counted = reset_launches()
        png_dir = os.path.join(EVAL_DIR, "png")
        os.makedirs(png_dir)
        for name, im in sets.items():
            for i, a in enumerate(im):
                write_png(os.path.join(png_dir, f"{name}_{i}.png"), a)
        npz = os.path.join(EVAL_DIR, "ref.npz")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):  # its values are logged below
            stats = fid.main(["ref", "--images", png_dir, "--out", npz])
            value = fid.main(["calc", "--images", png_dir, "--ref", npz])
        fid_s = time.perf_counter() - t0
        sigma = fid.FeatureStats.load(npz).finalize()[1]
        bound = fid.self_distance_bound(sigma)
        rmse, per = mse.rmse_between_dirs(png_dir, png_dir)
        for k, v in read_launches(counted).items():
            fid_launches[k] += v
        paths["eval_fid"] = (fid_launches, {"inception_ms": inc_ms, "inception_wall_ms": wall_ms,
                                            "images_s": images_s, "fid_s": fid_s})
        _expect("eval_fid", fid_launches, zero=tuple(k for k in fid_launches if "." not in k))
        log(f"[eval] fid ref + calc on {stats.count} PNGs of the sets above ({fid_s:.1f}s): FID "
            f"of the set against itself {value} (tr(Σ) {np.trace(sigma)}, bound {bound}: "
            f"D·√ε·λmax, the eigh form's rounding floor); RMSE of the directory against itself "
            f"{rmse} over {len(per)} images")
        check(abs(value) <= bound, f"[eval] FID of a set against itself {value} > {bound}")
        check(rmse == 0.0 and len(per) == stats.count, f"[eval] RMSE against itself {rmse}")
    finally:
        shutil.rmtree(EVAL_DIR, ignore_errors=True)
    log(f"[eval] {card}: the phase in {time.perf_counter() - t_phase:.1f}s")
    return paths


def phase_notebook(ckpt_path, card, seed=0):
    """`run_prompt_diffusion.main` once per NOTEBOOK_TASKS at NOTEBOOK_SIZE² and
    NOTEBOOK_STEPS DDIM steps, on the SD1.5 checkpoint `ckpt_path` and on a
    network-bsds500 `.pth` (HED, N(0, 1 / fan_in)) and an mmseg `.pth`
    (UniFormer-S, N(0, 0.02)) written from random modules; each PNG exists
    and is not constant. Returns (launches, timing)."""
    import shutil

    import numpy as np
    import torch
    from PIL import Image

    from prompt_diffusion_tpu_torch import run_prompt_diffusion
    from prompt_diffusion_tpu_torch.annotators.hed import HEDNetwork, export_hed_checkpoint
    from prompt_diffusion_tpu_torch.annotators.uniformer import (
        UniFormerSeg,
        export_uniformer_checkpoint,
    )
    from prompt_diffusion_tpu_torch.utils.dtypes import random_init_

    shutil.rmtree(NOTEBOOK_DIR, ignore_errors=True)
    os.makedirs(NOTEBOOK_DIR)
    try:
        with torch.device("cuda"):
            hed, seg = HEDNetwork(), UniFormerSeg()
        fan_in_init_(hed, torch.Generator(device="cuda").manual_seed(seed + 1), gain=1.0)
        random_init_(seg, torch.Generator(device="cuda").manual_seed(seed + 2))
        files = {"hed": os.path.join(NOTEBOOK_DIR, "network-bsds500.pth"),
                 "seg": os.path.join(NOTEBOOK_DIR, "upernet_global_small.pth")}
        torch.save({k.replace("net", "module", 1): v
                    for k, v in export_hed_checkpoint(hed).items()}, files["hed"])
        torch.save(export_uniformer_checkpoint(seg), files["seg"])
        del hed, seg
        # 640² sources: resize_image takes them to NOTEBOOK_SIZE² (the short
        # side to --resolution, each side rounded to a multiple of 64)
        rng = np.random.default_rng(seed)
        n = NOTEBOOK_SIZE * 5 // 4
        yy, xx = np.mgrid[:n, :n]
        scene = 255.0 * ((np.hypot(yy - n / 2, xx - n / 2.2) < n / 4) ^ (xx > n * 3 // 4))
        images = {}
        for name, shift in (("example", 0), ("query", n // 16)):
            img = np.clip(np.roll(scene, shift, axis=1)[..., None] + rng.normal(0, 20, (n, n, 3)),
                          0, 255).astype(np.uint8)
            images[name] = os.path.join(NOTEBOOK_DIR, f"{name}.png")
            Image.fromarray(img).save(images[name])
        counted = reset_launches()
        timing = {}
        for task in NOTEBOOK_TASKS:
            out = os.path.join(NOTEBOOK_DIR, f"out_{task}.png")
            t = time.perf_counter()
            run_prompt_diffusion.main([
                "--ckpt", ckpt_path, "--example-image", images["example"],
                "--query-image", images["query"], "--task", task, f"--{task}-ckpt", files[task],
                "--prompt", PROMPTS[0], "--resolution", str(NOTEBOOK_SIZE),
                "--steps", str(NOTEBOOK_STEPS),
                "--seed", str(seed), "--out", out])
            torch.cuda.synchronize()
            timing[task] = time.perf_counter() - t
            png = np.asarray(Image.open(out))
            check(png.shape == (NOTEBOOK_SIZE, NOTEBOOK_SIZE, 3) and png.std() > 0,
                  f"[notebook] {task}: the PNG is {png.shape} with std {png.std()}")
            log(f"[notebook] {card}: run_prompt_diffusion.main --task {task} at {NOTEBOOK_SIZE}², "
                f"{NOTEBOOK_STEPS} DDIM steps: {timing[task]:.2f} s (checkpoint load, annotator "
                f"build and pass, generate, PNG); PNG {png.shape}, std {png.std():.2f}")
        launches = read_launches(counted)
    finally:
        shutil.rmtree(NOTEBOOK_DIR, ignore_errors=True)
    for name in PATH_KERNELS["notebook"]:
        check(launches[name] > 0, f"kernel {name} was not launched on the notebook path")
    return launches, timing


def write_edit_root(root, n=TRAIN_IMAGES, size=TRAIN_SIZE, seed=0):
    """An EditDataset data root (laion_nonhuman/<dir>/<name>.jpg, each task's
    condition and a caption) of `n` random `size`² images in two folders:
    its train split (9 of every 10) fills a batch of TRAIN_BATCH distinct
    samples."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    for i in range(n):
        base = os.path.join(root, "laion_nonhuman", f"group{i % 2}")
        for sub in ("", "canny", "depth", "hed", "normal"):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
            # smooth random images: 16² noise upsampled
            img = Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8))
            img.resize((size, size), Image.BILINEAR).save(
                os.path.join(base, sub, f"img{i}.jpg"), quality=90)
        with open(os.path.join(base, f"img{i}.txt"), "w") as f:
            f.write(f"{PROMPTS[i % 2]} number {i}")
    return root


def trained(launches, tag):
    """The launches of a training path's kernels and their backward calls."""
    return {k: v for k, v in launches.items()
            if k in PATH_KERNELS[tag] or k.endswith(".backward")}


def module_states_equal(a, b):
    """Every tensor of module a's state dict equal to b's, bit for bit."""
    import torch

    sb = b.state_dict()
    return all(torch.equal(v, sb[k]) for k, v in a.state_dict().items())


def grad_check(pipe, seed=6000):
    """One SD1.5 loss and its ControlNet gradient on GRAD_BATCH samples at
    512² with fixed draws (t spread, no dropout), three ways: through the
    kernels, on the plain ops, and on the plain ops with fp32 compute (an
    fp32 twin of the UNet and ControlNet, same weights, same VAE latents).
    The kernels' gradient and loss terms must be no farther from the fp32
    ones than FP32_RATIO_BOUND times the plain bf16 ops' (global relative
    error: ||a - b|| / ||b|| over every element; the loss terms are the
    MSE's elementwise (pred - target)², whose mean is the loss). Returns
    the distances and the launches of the kernel run."""
    import torch

    import dataclasses

    from prompt_diffusion_tpu_torch.models.controlnet_sd15 import ControlNetSD15
    from prompt_diffusion_tpu_torch.models.unet_sd15 import UNetSD15
    from prompt_diffusion_tpu_torch.ops.dispatch import plain_ops
    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15
    from prompt_diffusion_tpu_torch.training import sd15 as tr
    from prompt_diffusion_tpu_torch.utils.dtypes import fp32_policy

    g = torch.Generator(device="cuda").manual_seed(seed)
    b, lat = GRAD_BATCH, TRAIN_SIZE // 8
    batch = {"image": torch.rand((b, TRAIN_SIZE, TRAIN_SIZE, 3), generator=g, device="cuda") * 2 - 1,
             "query": torch.rand((b, TRAIN_SIZE, TRAIN_SIZE, 3), generator=g, device="cuda"),
             "example_pair": torch.rand((b, TRAIN_SIZE, TRAIN_SIZE, 6), generator=g,
                                        device="cuda") * 2 - 1,
             "token_ids": torch.from_numpy(hash_token_ids([PROMPTS[0]] * b)),
             "null_ids": torch.from_numpy(hash_token_ids([""]))}
    draws = tr.Draws(torch.randn((b, 4, lat, lat), generator=g, device="cuda"),
                     torch.tensor([250, 900], device="cuda"),
                     torch.randn((b, 4, lat, lat), generator=g, device="cuda"),
                     torch.full((b,), 0.5, device="cuda"))
    cfg = tr.SD15TrainConfig()
    ucfg = dataclasses.replace(pipe.unet.config, use_checkpoint=True)
    with torch.device("cuda"):
        twin32 = PromptDiffusionSD15.create(
            unet=UNetSD15(ucfg, fp32_policy()), controlnet=ControlNetSD15(ucfg, 6, fp32_policy()),
            vae=pipe.vae, text_encoder=pipe.text_encoder, device="cuda")
    twin32.unet.load_state_dict(pipe.unet.state_dict())
    twin32.controlnet.load_state_dict(pipe.controlnet.state_dict())
    twin32.controlnet.requires_grad_(True)

    def run(p):
        pred, target = tr.sd15_pred_target(p, cfg, tr.device_batch(batch, "cuda"), draws)
        terms = (pred.float() - target.float()) ** 2
        loss = terms.mean()
        grads = torch.autograd.grad(loss, list(p.controlnet.parameters()))
        return (loss.item(), terms.detach().flatten(),
                torch.cat([x.float().flatten() for x in grads]))

    counted = reset_launches()
    kern = run(pipe)
    launches = read_launches(counted)
    with plain_ops():
        plain = run(pipe)
        ref = run(twin32)
    del twin32
    torch.cuda.empty_cache()
    rel = lambda a, r: ((a - r).norm() / r.norm()).item()
    out = {"loss": {"kernels": kern[0], "plain": plain[0], "fp32": ref[0]},
           "terms_rel": {"kernels": rel(kern[1], ref[1]), "plain": rel(plain[1], ref[1])},
           "grad_rel": {"kernels": rel(kern[2], ref[2]), "plain": rel(plain[2], ref[2])}}
    log(f"[train] gradient check (batch {b} at {TRAIN_SIZE}², t {draws.t.tolist()}, no dropout): "
        f"loss kernels {kern[0]}, plain {plain[0]}, fp32 {ref[0]}; against the fp32-compute "
        f"plain evaluation, the loss terms' relative L2 kernels {out['terms_rel']['kernels']} "
        f"plain {out['terms_rel']['plain']}, the ControlNet gradient's kernels "
        f"{out['grad_rel']['kernels']} plain {out['grad_rel']['plain']} (bound "
        f"{FP32_RATIO_BOUND}x the plain ops'); launches {trained(launches, 'train')}")
    for what in ("terms_rel", "grad_rel"):
        k, p = out[what]["kernels"], out[what]["plain"]
        check(k <= FP32_RATIO_BOUND * p, f"[train] {what}: kernels {k} vs plain {p} from fp32")
    for name in DIFFERENTIABLE:
        if name != "flash_attention":
            check(launches[f"{name}.backward"] > 0, f"[train] no backward of {name} in the check")
    return out, launches


def backward_times():
    """Device ms of each differentiable kernel's backward (the plain
    version's autograd, recomputed from the saved inputs) at the training
    paths' shapes, beside SDPA's backward at the attention shapes (the
    yardstick of a hand-written attention backward)."""
    import torch
    import torch.nn.functional as F

    from prompt_diffusion_tpu_torch.ops import flash_attention as fa
    from prompt_diffusion_tpu_torch.ops.dispatch import recompute_grads
    from prompt_diffusion_tpu_torch.ops.fused_layer_norm import _torch_layer_norm
    from prompt_diffusion_tpu_torch.ops.norms import group_norm
    from prompt_diffusion_tpu_torch.tools.timing import device_ms, roofline

    g = torch.Generator(device="cuda").manual_seed(7000)
    bf = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
    f32 = lambda *s: torch.randn(s, generator=g, device="cuda")
    rows = {}

    def attn(label, fn, inputs, heads, sdpa_shape):
        gout = torch.randn_like(inputs[0])
        ms = device_ms(lambda: fa._recompute_grads(fn, gout, inputs, (True,) * 3, heads),
                       iters=3, warmup=1)
        b, n, h, d = sdpa_shape
        qs = [t.reshape(b, n, h, d).transpose(1, 2).detach().requires_grad_() for t in inputs]
        out = F.scaled_dot_product_attention(*qs)
        go = torch.randn_like(out)
        lib = device_ms(lambda: torch.autograd.grad(out, qs, go, retain_graph=True),
                        iters=3, warmup=1)
        # q, k, v and the output's gradient read, dq, dk, dv written; the
        # logits recomputed and four products (dV, dP, dQ, dK), each
        # 2 N² D per head; one exponential per logit
        bound, term = roofline(7 * 2 * b * n * h * d, bf16_ops=10 * b * h * n * n * d,
                               exps=b * h * n * n)
        rows[label] = {"ms": ms, "sdpa_bwd_ms": lib, "bound_ms": bound, "bound_term": term}

    def norm(label, fn, inputs):
        gx = torch.randn_like(inputs[0])
        ms = device_ms(lambda: recompute_grads(fn, gx, inputs, (True,) * 3), iters=3, warmup=1)
        # x and its gradient read, dx written
        bound, term = roofline(3 * inputs[0].numel() * inputs[0].element_size())
        rows[label] = {"ms": ms, "bound_ms": bound, "bound_term": term}

    attn("K1 (8,4096,320) H=8", lambda q, k, v: fa._packed_ref(q, k, v, 8, 40 ** -0.5),
         [bf(8, 4096, 320) for _ in range(3)], 8, (8, 4096, 8, 40))
    attn("K2 (1,4429,24,64)", lambda q, k, v: fa._torch_attention(q, k, v, 64 ** -0.5),
         [bf(1, 4429, 24, 64) for _ in range(3)], 24, (1, 4429, 24, 64))
    attn("K2 (1,16384,1,512)", lambda q, k, v: fa._torch_attention(q, k, v, 512 ** -0.5),
         [bf(1, 16384, 1, 512) for _ in range(3)], 1, (1, 16384, 1, 512))
    gn = lambda x_, s_, b_: group_norm(x_, 32, s_, b_, apply_silu=True)
    cl = lambda t: t.contiguous(memory_format=torch.channels_last)
    norm("K3 (8,320,64,64) SiLU", gn, (cl(bf(8, 320, 64, 64)), f32(320), f32(320)))
    norm("K3 (1,128,1024,1024) SiLU", gn, (cl(bf(1, 128, 1024, 1024)), f32(128), f32(128)))
    norm("K4 (32768,320)", lambda x_, s_, b_: _torch_layer_norm(x_, s_, b_, 1e-5),
         (bf(8, 4096, 320), f32(320), f32(320)))
    for label, r in rows.items():
        log(f"[train] backward {label}: plain recompute device_ms={r['ms']}"
            + (f" sdpa_backward_device_ms={r['sdpa_bwd_ms']}" if "sdpa_bwd_ms" in r else "")
            + f" bound_ms={r['bound_ms']} ({r['bound_term']})")
    return rows


def phase_train(card):
    """SD1.5 ControlNet training at BASELINE config 5 through the entry
    `train_sd15.main` (default widths, 1.43 B parameters, random weights
    from seed 0, bf16, gradient checkpointing, EMA) on a synthetic data
    root: TRAIN_STEPS steps saving at step 2, the saved state restored bit
    for bit, one `--resume`d step; the frozen models bit-unchanged and the
    ControlNet moved; the gradient check; the backward times; then SD3 at
    full width through `train_sd3.main` (batch 1 at 1024²). Returns {path
    tag: (launches, timing)}."""
    import shutil

    import numpy as np
    import torch

    from prompt_diffusion_tpu_torch import train_sd3, train_sd15
    from prompt_diffusion_tpu_torch.training import checkpoint as ckpt
    from prompt_diffusion_tpu_torch.training import sd15 as tr
    from prompt_diffusion_tpu_torch.training.optimizer import step_generator

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    out = {}
    try:
        root = write_edit_root(os.path.join(TRAIN_DIR, "data"))
        log(f"[train] data root: {TRAIN_IMAGES} random {TRAIN_SIZE}² images with 4 conditions "
            f"and a caption each, in {time.perf_counter() - t0:.1f}s")
        logdir = os.path.join(TRAIN_DIR, "sd15")
        argv = ["--data-root", root, "--logdir", logdir, "--batch-size", str(TRAIN_BATCH),
                "--accum-steps", "1", "--resolution", str(TRAIN_SIZE), "--use-checkpoint",
                "--use-ema", "--ckpt-every", "2", "--image-log-every", "0", "--seed", "0",
                "--device", "cuda"]
        torch.cuda.reset_peak_memory_stats()
        counted = reset_launches()
        t = time.perf_counter()
        run_a = train_sd15.main(argv + ["--max-steps", str(TRAIN_STEPS)])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        launches = read_launches(counted)
        peak = torch.cuda.max_memory_allocated()
        losses = [m["loss"] for m in run_a["metrics"]]
        step_s = run_a["step_s"]
        steady = float(np.mean(step_s[1:]))
        log(f"[train] {card}: SD1.5 ControlNet, batch {TRAIN_BATCH} at {TRAIN_SIZE}², "
            f"grad-accum 1, gradient checkpointing, EMA, bf16 with fp32 masters: "
            f"{TRAIN_STEPS} steps through train_sd15.main in {run_s:.1f}s (pipeline build and "
            f"saves included); seconds per step {step_s} (the first with the warm-up); "
            f"{steady:.3f} s/step and {TRAIN_BATCH / steady:.2f} samples/s after the first; "
            f"peak device memory {peak / 2**30:.2f} GiB; losses {losses}")
        per_step = {k: v / TRAIN_STEPS for k, v in trained(launches, "train").items()}
        log(f"[train] launches per step (forward, checkpoint recompute included; backward "
            f"calls as .backward): {per_step}")
        check(all(np.isfinite(losses)), f"[train] non-finite loss {losses}")
        for name in PATH_KERNELS["train"]:
            check(launches[name] > 0, f"kernel {name} was not launched on the train path")
        for name in ("flash_attention_packed", "fused_group_norm", "fused_layer_norm"):
            check(launches[f"{name}.backward"] > 0, f"[train] no backward of {name}")
            check(launches[name] >= launches[f"{name}.backward"],
                  f"[train] {name}: more backwards than forwards")
        check(launches["flash_attention.backward"] == 0,
              "[train] K2 ran a backward in the SD1.5 step (its VAE encode has no gradient)")

        pipe_a, state_a = run_a["pipe"], run_a["state"]
        ref = train_sd15.build_pipe(False, "cuda", True)
        train_sd15.init_weights(ref, 0)
        frozen_same = {n: module_states_equal(getattr(ref, a), getattr(pipe_a, a))
                       for n, a in (("unet", "unet"), ("vae", "vae"), ("clip", "text_encoder"))}
        cn_moved = not module_states_equal(ref.controlnet, pipe_a.controlnet)
        log(f"[train] after {TRAIN_STEPS} steps: UNet, VAE, CLIP bit-unchanged {frozen_same}; "
            f"ControlNet moved {cn_moved}")
        check(all(frozen_same.values()) and cn_moved, "[train] trained the wrong modules")

        # the saved step: read back into a fresh state of the same run
        cfg = tr.SD15TrainConfig(use_ema=True, accum_steps=1)
        template = tr.init_train_state(cfg, ref, seed=1)
        manager = ckpt.make_manager(os.path.join(logdir, "checkpoints"), save_every=2)
        steps_saved = manager.all_steps()
        restored, step = ckpt.restore_state(manager, template)
        manager.close()
        mine, saved = state_a.tensors(), restored.tensors()
        same = all(torch.equal(mine[k], saved[k]) for k in mine) and mine.keys() == saved.keys()
        log(f"[train] checkpoints {steps_saved}; step {step} restored into a fresh state: "
            f"masters, moments and EMA ({len(mine)} tensors, "
            f"{sum(t.numel() * t.element_size() for t in mine.values()) / 1e9:.2f} GB) bit-equal "
            f"{same}; counters {restored.meta() == state_a.meta()} ({restored.meta()['step']})")
        check(steps_saved == [0, 2] and step == TRAIN_STEPS - 1, f"[train] saved {steps_saved}")
        check(same and restored.meta() == state_a.meta(), "[train] the restored state differs")
        del ref, template, restored, pipe_a, run_a
        torch.cuda.empty_cache()

        t = time.perf_counter()
        run_b = train_sd15.main(argv + ["--max-steps", str(TRAIN_STEPS + 1), "--resume"])
        torch.cuda.synchronize()
        state_b = run_b["state"]
        shape = (TRAIN_BATCH, 4, TRAIN_SIZE // 8, TRAIN_SIZE // 8)
        d_a = tr.make_draws(step_generator(state_a.seed, TRAIN_STEPS, "cuda"), shape, 1000)
        d_b = tr.make_draws(step_generator(state_b.seed, run_b["start_step"], "cuda"), shape,
                            1000)
        draws_same = all(torch.equal(x, y) for x, y in zip(d_a, d_b))
        log(f"[train] --resume: started at step {run_b['start_step']}, loss "
            f"{run_b['metrics'][0]['loss']} in {time.perf_counter() - t:.1f}s; its draws equal "
            f"the uninterrupted run's {draws_same}")
        check(run_b["start_step"] == TRAIN_STEPS and draws_same and state_b.step == TRAIN_STEPS + 1
              and np.isfinite(run_b["metrics"][0]["loss"]), "[train] the resumed run is wrong")
        del state_a
        grads, grad_launches = grad_check(run_b["pipe"])
        del run_b, state_b
        torch.cuda.empty_cache()
        bwd = backward_times()
        out["train"] = (launches, {"step_s": step_s, "steady_step_s": steady,
                                   "samples_per_s": TRAIN_BATCH / steady, "peak_bytes": peak,
                                   "losses": losses, "grad_check": grads, "backward": bwd})

        # SD3 at full width
        torch.cuda.reset_peak_memory_stats()
        counted = reset_launches()
        t = time.perf_counter()
        sd3_argv = ["--data-root", root, "--logdir", os.path.join(TRAIN_DIR, "sd3"),
                    "--batch-size", str(SD3_TRAIN_BATCH), "--resolution", str(SD3_SIZE),
                    "--max-steps", str(SD3_TRAIN_STEPS), "--ckpt-keep", "1", "--seed", "0",
                    "--device", "cuda"]
        run3 = train_sd3.main(sd3_argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        launches3 = read_launches(counted)
        peak3 = torch.cuda.max_memory_allocated()
        pipe3 = run3["pipe"]
        n_params = {n: sum(p.numel() for p in m.parameters())
                    for n, m in pipe3.jax_modules().items()}
        nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
        frozen_gb = nbytes(p for n in ("transformer", "vae", "clip_l", "clip_g")
                           for p in getattr(pipe3, n).parameters()) / 2**30
        state_gb = (nbytes(run3["state"].params)
                    + nbytes(run3["state"].tensors().values())) / 2**30
        losses3 = [m["loss"] for m in run3["metrics"]]
        steady3 = float(np.mean(run3["step_s"][1:]))
        log(f"[train] {card}: SD3 ({n_params}) at full width, batch {SD3_TRAIN_BATCH} at "
            f"{SD3_SIZE}², bf16 with fp32 masters: {SD3_TRAIN_STEPS} steps through "
            f"train_sd3.main in {run_s:.1f}s; seconds per step {run3['step_s']}; {steady3:.3f} "
            f"s/step after the first; peak device memory {peak3 / 2**30:.2f} GiB (frozen "
            f"models {frozen_gb:.2f} GiB, trainable weights, fp32 masters and moments "
            f"{state_gb:.2f} GiB, the rest gradients and activations); losses "
            f"{losses3}; launches {trained(launches3, 'train_sd3')}")
        check(all(np.isfinite(losses3)), f"[train] SD3 non-finite loss {losses3}")
        ref3 = train_sd3.build_pipe(False, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        from prompt_diffusion_tpu_torch.utils.dtypes import random_init_

        for m in ref3.jax_modules().values():
            random_init_(m, gen)
        same3 = {n: module_states_equal(getattr(ref3, n), getattr(pipe3, n))
                 for n in ("transformer", "vae", "controlnet", "down_proj")}
        log(f"[train] SD3 after {SD3_TRAIN_STEPS} steps, bit-unchanged: {same3}")
        check(same3["transformer"] and same3["vae"] and not same3["controlnet"]
              and not same3["down_proj"], "[train] SD3 trained the wrong modules")
        for name in PATH_KERNELS["train_sd3"]:
            check(launches3[name] > 0, f"kernel {name} was not launched on the SD3 train path")
            check(launches3[f"{name}.backward"] > 0, f"[train] SD3: no backward of {name}")
        # the support pair's VAE encode alone: K2 (its mid-block attention)
        # and K3 run forward and backward to down_proj
        g = torch.Generator(device="cuda").manual_seed(8000)
        img = lambda: torch.rand((1, SD3_SIZE, SD3_SIZE, 3), generator=g, device="cuda") * 2 - 1
        counted = reset_launches()
        lat = pipe3.support_pair_latents(img(), img(), noise=torch.randn(
            (1, pipe3.vae.config.z_channels, SD3_SIZE // 8, SD3_SIZE // 8), generator=g,
            device="cuda"))
        lat.square().mean().backward()
        pair = trained(read_launches(counted), "train_sd3")
        log(f"[train] SD3 support pair encode with its gradient to down_proj: launches {pair}")
        check(pair["flash_attention"] == pair["flash_attention.backward"] == 1
              and pair["fused_group_norm.backward"] > 0
              and all(p.grad is not None for p in pipe3.down_proj.parameters()),
              "[train] the support pair's VAE encode ran no K2 or K3 backward")
        out["train_sd3"] = (launches3, {"step_s": run3["step_s"], "steady_step_s": steady3,
                                        "peak_bytes": peak3, "frozen_gib": frozen_gb,
                                        "state_gib": state_gb, "losses": losses3})
        del run3, pipe3, ref3
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    log(f"[train] the phase in {time.perf_counter() - t0:.1f}s")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "prompt_diffusion_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    # the fp32 references run in full fp32: no TF32 in matmuls or convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from prompt_diffusion_tpu_torch.utils.dtypes import (
        DTypePolicy,
        default_policy,
        fp32_policy,
        int8_policy,
    )

    from prompt_diffusion_tpu_torch.tools import timing

    card = timing.card()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    from prompt_diffusion_tpu_torch.ops._build import cuda_ext

    cuda_ext()
    nvcc_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(0)
    for case in kernel_cases(gen):  # compiles the Triton kernels
        case[2](*case[3])
    torch.cuda.synchronize()
    log(f"[build] nvcc + load {nvcc_s:.1f}s; first launch of every kernel "
        f"(Triton compile included) {time.perf_counter() - t0 - nvcc_s:.1f}s")

    results = phase_kernels(gen)
    k3_k5 = k3_k5_statistics(gen)
    paths, slice_pipe, slice_img1 = phase_path("slice", default_policy(), False, fp32_policy(),
                                               keep_pipe=True)
    int8_paths, int8_pipe, _ = phase_path("int8", int8_policy(), True,
                                       DTypePolicy(compute_dtype=torch.float32, quant="int8"),
                                       info_policy=default_policy(), keep_pipe=True)
    paths.update(int8_paths)
    paths["serve"] = phase_serve(int8_pipe, card)
    del int8_pipe
    torch.cuda.empty_cache()
    paths.update(phase_ckpt(slice_pipe, slice_img1, card))
    paths.update(phase_eval(slice_pipe, slice_img1, card))
    del slice_pipe
    torch.cuda.empty_cache()
    paths["sd3"] = phase_sd3()
    paths["adaln"] = phase_adaln()
    paths["labs"] = phase_labs()
    midas_paths, dpt, batches = phase_midas(card)
    paths.update(midas_paths)
    paths.update(phase_annotators(card, dpt, batches, paths["midas"][1]))
    del dpt, batches
    torch.cuda.empty_cache()
    paths.update(phase_train(card))
    for tag in ("slice", "int8", "sd3"):
        timing = paths[tag][1]
        per_req = timing["request_s"]
        if tag == "sd3":
            log(f"[sd3] {card}: {per_req[1]:.3f} s per request (batch {SD3_BATCH}, "
                f"{SD3_SIZE}², {SD3_STEPS} flow-match steps, CFG {SD3_CFG}, staged T5; first "
                f"request {per_req[0]:.3f} s), {timing['step_s']:.4f} s per denoise step "
                f"(ControlNet + MMDiT, CFG batch {2 * SD3_BATCH}); T5-XXL encode "
                f"{timing['t5_ms']:.1f} ms per prompt")
            continue
        log(f"[{tag}] {card}: {per_req[1]:.3f} s per request (batch {REQ_BATCH}, {REQ_SIZE}², "
            f"{REQ_STEPS} DDIM steps, CFG {CFG}; first request {per_req[0]:.3f} s), "
            f"{timing['step_s']:.4f} s per denoise step (ControlNet + UNet, CFG batch "
            f"{2 * REQ_BATCH})")

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        cases = results[name]
        by_path = {tag: launches[name] for tag, (launches, _) in paths.items()}
        main_case = cases[0]
        also = {"replaces_also": ALSO_REPLACES[name]} if name in ALSO_REPLACES else {}
        if name in DEVICE_FUNCTIONS:
            also["device_functions"] = DEVICE_FUNCTIONS[name]
        if name == "fused_group_norm":  # the ReLU epilogue's share of the launches
            also["relu_launches"] = sum(launches["fused_group_norm.relu"]
                                        for launches, _ in paths.values()
                                        if "fused_group_norm.relu" in launches)
            also["k5_statistics"] = k3_k5
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        **also, "launches": sum(by_path.values()), "launches_by_path": by_path,
                        "max_abs_err": max(c["max_abs_err"] for c in cases),
                        **{k: main_case[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                     "bound_term", "library_ms", "wall_ms")},
                        "cases": cases})
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
