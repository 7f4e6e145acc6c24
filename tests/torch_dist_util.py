"""Several gloo ranks on the CPU for the port's sharding tests
(tests/test_torch_parallel.py, tests/test_torch_tensor_parallel.py).

`spawn(worker, world, workdir)` starts `world` processes with
`torch.multiprocessing.spawn`, each joined to one gloo group through a
`file://` rendezvous in `workdir` (so parallel test workers never share a
port) on one thread. A worker reads its inputs from `workdir/inputs.pt`,
which the test wrote, and writes what it measured to
`workdir/rank<r>.pt`. This module imports no JAX: the children run the
port only, the test process holds both frameworks.
"""

import os
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy, default_policy
from tests.torch_port_util import TINY_CLIP, TINY_UNET, TINY_VAE

INT8_F32 = DTypePolicy(compute_dtype=torch.float32, quant="int8")
# the SD1.5 sharded generates beside the fp32 one: name -> (UNet and
# ControlNet policy, eta)
GENERATE_VARIANTS = {"int8": (INT8_F32, 0.0), "int8_eta": (INT8_F32, 1.0),
                     "bf16_eta": (default_policy(), 0.5)}

# the tiny SD3 widths of tests/test_torch_train_sd3.py (4 heads: TP width 2)
TCFG = dict(sample_size=8, patch_size=2, in_channels=4, num_layers=2, attention_head_dim=16,
            num_attention_heads=4, joint_attention_dim=64, caption_projection_dim=64,
            pooled_projection_dim=56, out_channels=4, pos_embed_max_size=16)
SD3_CLIP = dict(vocab_size=100, hidden_size=32, num_layers=1, num_heads=4, intermediate_size=64)
SD3_VAE = dict(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1, z_channels=4,
               scale_factor=1.5305, shift_factor=0.0609)


def _entry(rank, worker, world, workdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous",
                            rank=rank, world_size=world)
    try:
        inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
        out = worker(rank, world, inputs, workdir)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(worker, world, workdir, inputs):
    """Runs worker(rank, world, inputs, workdir) -> result on `world` gloo
    ranks; returns the results by rank."""
    os.makedirs(workdir, exist_ok=True)
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    mp.spawn(_entry, args=(worker, world, workdir), nprocs=world, join=True)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def tiny_sd15(policy=None):
    """The tiny SD1.5 pipeline of the parity tests on the CPU (fp32 by
    default)."""
    from prompt_diffusion_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from prompt_diffusion_tpu_torch.models.controlnet_sd15 import ControlNetSD15
    from prompt_diffusion_tpu_torch.models.unet_sd15 import UNetConfig, UNetSD15
    from prompt_diffusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd15 import PromptDiffusionSD15
    from prompt_diffusion_tpu_torch.utils.dtypes import fp32_policy

    pol = policy or fp32_policy()
    return PromptDiffusionSD15.create(
        unet=UNetSD15(UNetConfig(**TINY_UNET), pol),
        controlnet=ControlNetSD15(UNetConfig(**TINY_UNET), 6, pol),
        vae=AutoencoderKL(VAEConfig(**TINY_VAE), fp32_policy()),
        text_encoder=CLIPTextModel(CLIPTextConfig(**TINY_CLIP), fp32_policy()), device="cpu")


def tiny_sd3(clip_layers=1, pooled=56, policy=None):
    """The tiny SD3 pipeline of tests/test_torch_train_sd3.py, fp32; for
    `generate`, CLIP with two layers (it reads the second to last) and the
    pooled width the two CLIPs give (64); `policy` that of the MMDiT and
    the ControlNet (fp32 by default)."""
    from prompt_diffusion_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from prompt_diffusion_tpu_torch.models.controlnet_sd3 import (
        SD3ControlNet,
        SupportPairDownProj,
    )
    from prompt_diffusion_tpu_torch.models.mmdit_sd3 import MMDiTConfig, SD3Transformer
    from prompt_diffusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from prompt_diffusion_tpu_torch.pipelines.prompt_diffusion_sd3 import PromptDiffusionSD3
    from prompt_diffusion_tpu_torch.utils.dtypes import fp32_policy

    pol, cfg = fp32_policy(), MMDiTConfig(**dict(TCFG, pooled_projection_dim=pooled))
    return PromptDiffusionSD3.create(
        transformer=SD3Transformer(cfg, policy or pol),
        controlnet=SD3ControlNet(cfg, policy or pol), down_proj=SupportPairDownProj(pol),
        vae=AutoencoderKL(VAEConfig(**SD3_VAE), pol),
        clip_l=CLIPTextModel(CLIPTextConfig(**dict(SD3_CLIP, num_layers=clip_layers)), pol),
        clip_g=CLIPTextModel(CLIPTextConfig(**dict(SD3_CLIP, num_layers=clip_layers)), pol),
        device="cpu")


def load(pipe, state_dicts):
    for name, m in pipe.jax_modules().items():
        m.load_state_dict(state_dicts[name])
    return pipe


def rows(x, rank, world):
    """Rank `rank`'s rows of a global batch (numpy arrays, tensors, dicts)."""
    if isinstance(x, dict):
        return {k: rows(v, rank, world) for k, v in x.items()}
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n] if x.shape[0] > 1 else x


def step_record(state, metrics, trained):
    """What a test compares of one step: loss, grad_norm, and the trained
    modules' tensors (all-gathered into them after the update)."""
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "params": {n: {k: v.clone() for k, v in m.state_dict().items()}
                       for n, m in trained.items()}}


def sd15_train_worker(rank, world, inputs, workdir):
    """The SD1.5 checks of tests/test_torch_parallel.py on one rank: one
    step on each mesh of inputs["meshes"]; two micro-steps with
    accumulation and the EMA on 1 x world; a checkpoint saved after step 0
    on 1 x world, the next step run on and restored at world size `world`;
    sharded generate and the sharded FID statistics."""
    from prompt_diffusion_tpu_torch.parallel.mesh import make_mesh
    from prompt_diffusion_tpu_torch.pipelines.sharded import generate_sharded
    from prompt_diffusion_tpu_torch.training import checkpoint as ckpt
    from prompt_diffusion_tpu_torch.training import sd15 as tr

    batch, draws = inputs["batch"], inputs["draws"]
    local = rows(batch, rank, world)
    out = {"steps": {}}

    def fresh(mesh, **kw):
        pipe = load(tiny_sd15(), inputs["state_dicts"])
        cfg = tr.SD15TrainConfig(**inputs["cfg"], **kw)
        state = tr.init_train_state(cfg, pipe, mesh=mesh)
        return pipe, state, tr.make_train_step(pipe, cfg)

    for shape in inputs["meshes"]:
        mesh = make_mesh(*shape, device="cpu")
        pipe, state, step = fresh(mesh)
        m = step(state, local, draws[0])
        out["steps"][shape] = step_record(state, m, {"controlnet": pipe.controlnet})
        out["steps"][shape]["local_bytes"] = state.local_bytes()

    mesh = make_mesh(1, world, device="cpu")
    pipe, state, step = fresh(mesh, accum_steps=2, use_ema=True)
    ms = [step(state, local, draws[s]) for s in range(2)]
    out["accum"] = {"losses": [float(m["loss"]) for m in ms],
                    "tensors": {k: v.clone() for k, v in state.tensors().items()},
                    "meta": state.meta()}

    pipe, state, step = fresh(mesh, use_ema=True)
    manager = ckpt.make_manager(os.path.join(workdir, "ckpt"), save_every=1)
    step(state, local, draws[0])
    ckpt.save_state(manager, 0, state, force=True)
    ckpt.save_final(manager, 0, state)  # waits for the write and every rank
    saved = {k: v.clone() for k, v in state.tensors().items()}
    on = step(state, local, draws[1])
    pipe2, state2, step2 = fresh(mesh, use_ema=True)
    _, at = ckpt.restore_state(manager, state2)
    manager.close()
    restored = state2.tensors()
    out["ckpt"] = {"at": at, "saved": saved,
                   "restored_equal": all(torch.equal(restored[k], saved[k]) for k in saved),
                   "on": step_record(state, on, {"controlnet": pipe.controlnet}),
                   "resumed": step_record(state2, step2(state2, local, draws[1]),
                                          {"controlnet": pipe2.controlnet})}

    gen = inputs["generate"]
    seeded = lambda: torch.Generator().manual_seed(inputs["generate_seed"])
    pipe = load(tiny_sd15(), inputs["state_dicts"])
    out["generate"] = generate_sharded(pipe, mesh, **gen, generator=seeded())
    out["variants"] = generate_variants(mesh, inputs["state_dicts"], gen, seeded)
    try:
        make_mesh(1, 3, device="cpu")
    except ValueError as e:
        out["refusal"] = str(e)

    from prompt_diffusion_tpu_torch.evaluation.fid import (
        compute_stats_from_iterator_sharded,
        compute_stats_sharded,
    )

    w = torch.from_numpy(inputs["fid_w"])
    feature_fn = lambda x01: x01.mean(dim=(1, 2)) @ w
    fid = inputs["fid"]
    out["fid"] = compute_stats_sharded(feature_fn, fid["images"], mesh, device="cpu")
    out["fid_stream"] = compute_stats_from_iterator_sharded(
        feature_fn, iter(fid["batches"]), w.shape[1], mesh, device="cpu")
    return out


def generate_variants(mesh, state_dicts, gen, seeded):
    """SD1.5 `generate_sharded` under each of GENERATE_VARIANTS (the
    images, and the all-reduces of the int8 activation scale), then two
    mutations held to fall outside the bounds: the int8 scale taken over
    the rank's rows alone, and eta's step noise drawn for the rank's rows
    alone."""
    from prompt_diffusion_tpu_torch.ops import quant
    from prompt_diffusion_tpu_torch.pipelines import prompt_diffusion_sd15 as psd
    from prompt_diffusion_tpu_torch.pipelines.sharded import generate_sharded

    out = {}
    run = lambda name: generate_sharded(load(tiny_sd15(GENERATE_VARIANTS[name][0]), state_dicts),
                                        mesh, **gen, eta=GENERATE_VARIANTS[name][1],
                                        generator=seeded())
    for name in GENERATE_VARIANTS:
        quant.quant_act.all_reduces = 0
        out[name] = (run(name), quant.quant_act.all_reduces)
    with mock.patch.object(quant, "batch_shard", lambda: None):
        out["rank_local_scale"] = run("int8")
    with mock.patch.object(psd, "batch_shard", lambda: None):
        out["rank_local_noise"] = run("int8_eta")
    return out


def sd3_train_worker(rank, world, inputs, workdir):
    """One SD3 step on each mesh of inputs["meshes"]; sharded generate at
    fp32 and under the int8 policy."""
    from prompt_diffusion_tpu_torch.ops import quant
    from prompt_diffusion_tpu_torch.parallel.mesh import make_mesh
    from prompt_diffusion_tpu_torch.pipelines.sharded import generate_sharded
    from prompt_diffusion_tpu_torch.training import sd3 as tr

    local = rows(inputs["batch"], rank, world)
    mesh = make_mesh(1, world, device="cpu")
    run = lambda policy: generate_sharded(
        load(tiny_sd3(2, 64, policy), inputs["generate_state_dicts"]), mesh,
        **inputs["generate"], generator=torch.Generator().manual_seed(inputs["generate_seed"]))
    out = {"generate": run(None)}
    quant.quant_act.all_reduces = 0
    out["generate_int8"] = (run(INT8_F32), quant.quant_act.all_reduces)
    for shape in inputs["meshes"]:
        mesh = make_mesh(*shape, device="cpu")
        pipe = load(tiny_sd3(), inputs["state_dicts"])
        cfg = tr.SD3TrainConfig(**inputs["cfg"])
        state = tr.init_sd3_train_state(cfg, pipe, mesh=mesh)
        m = tr.make_sd3_train_step(pipe, cfg)(state, local, inputs["draws"][0])
        out[shape] = step_record(state, m, {"controlnet": pipe.controlnet,
                                            "down_proj": pipe.down_proj})
    return out


def tp_worker(rank, world, inputs, workdir):
    """The tiny MMDiT and SD3 ControlNet forwards with `apply_tp` at tensor
    width `world`, at fp32 and under the int8 policy (fp32 compute; the
    unsharded int8 forwards first, in this process), and the split K10 /
    K11's launches (`act_amax`, `act_codes`) of the int8 forwards."""
    from prompt_diffusion_tpu_torch.models.controlnet_sd3 import SD3ControlNet
    from prompt_diffusion_tpu_torch.models.mmdit_sd3 import MMDiTConfig, SD3Transformer
    from prompt_diffusion_tpu_torch.ops import fused_act
    from prompt_diffusion_tpu_torch.parallel.tensor_parallel import apply_tp, make_tp_mesh
    from prompt_diffusion_tpu_torch.utils.dtypes import fp32_policy

    mesh = make_tp_mesh(num_tensor=world, device="cpu")
    x = inputs["x"]

    def models(policy):
        tr = SD3Transformer(MMDiTConfig(**TCFG), policy)
        tr.load_state_dict(inputs["transformer"])
        cn = SD3ControlNet(MMDiTConfig(**TCFG), policy)
        cn.load_state_dict(inputs["controlnet"])
        return tr, cn

    def forward(tr, cn):
        with torch.no_grad():
            return {"transformer": tr(x["lat"], x["t"], x["ctx"], x["pooled"]),
                    "controlnet": cn(x["lat"], x["t"], x["lat"], x["lat"], x["ctx"],
                                     x["pooled"])}

    tr, cn = models(fp32_policy())
    apply_tp(tr, mesh)
    apply_tp(cn, mesh)
    out = forward(tr, cn)
    out["heads"] = tr.blocks_0.heads
    out["to_q_rows"] = tr.blocks_0.to_q.weight.shape[0]

    tr, cn = models(INT8_F32)
    out["int8_unsharded"] = forward(tr, cn)
    apply_tp(tr, mesh)
    apply_tp(cn, mesh)
    calls = []
    with mock.patch.object(fused_act, "split_act_quant",
                           _recording(fused_act.split_act_quant, calls)):
        out["int8"] = forward(tr, cn)
    out["split_calls"] = calls
    return out


def _recording(fn, log):
    """`fn`, recording each call's (width, gelu, group size)."""
    def wrapped(x, gelu, group=None):
        log.append((x.shape[-1], gelu, 1 if group is None else dist.get_world_size(group)))
        return fn(x, gelu, group)
    return wrapped


def np_batches(rng: np.random.Generator, sizes, res=8):
    return [rng.uniform(0, 1, (n, res, res, 3)).astype(np.float32) for n in sizes]


def entries_worker(rank, world, inputs, workdir):
    """The three trainers and the FID entry as `torchrun` starts them (the
    launcher's variables set, the group already joined): train_sd15 three
    steps whole, and two steps then `--resume` to three; finetune_sd15 and
    train_sd3 a step each; `fid ref --sharded`; a global batch the world
    does not divide."""
    from prompt_diffusion_tpu_torch import finetune_sd15, train_sd3, train_sd15
    from prompt_diffusion_tpu_torch.evaluation import fid

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    root, out = inputs["root"], {}
    base = ["--data-root", root, "--tiny", "--device", "cpu", "--batch-size", "2",
            "--resolution", "32", "--accum-steps", "1", "--image-log-every", "0", "--use-ema",
            "--ckpt-every", "2", "--num-fsdp", str(world), "--loader", "pil"]
    whole = train_sd15.main(base + ["--logdir", f"{workdir}/a", "--max-steps", "3"])
    train_sd15.main(base + ["--logdir", f"{workdir}/b", "--max-steps", "2"])
    resumed = train_sd15.main(base + ["--logdir", f"{workdir}/b", "--max-steps", "3",
                                      "--resume"])
    out["sd15"] = {name: {"losses": [m["loss"] for m in run["metrics"]],
                          "start": run["start_step"], "meta": run["state"].meta(),
                          "tensors": {k: v.clone() for k, v in run["state"].tensors().items()},
                          "mesh": tuple(run["mesh"].shape)}
                   for name, run in (("whole", whole), ("resumed", resumed))}
    ft = finetune_sd15.main(["--data-root", root, "--task", "canny", "--tiny", "--device", "cpu",
                             "--batch-size", "2", "--resolution", "32", "--max-steps", "1",
                             "--num-supports", "3", "--logdir", f"{workdir}/ft",
                             "--num-fsdp", str(world)])
    sd3 = train_sd3.main(["--data-root", root, "--tiny", "--device", "cpu", "--batch-size", "2",
                          "--resolution", "64", "--max-steps", "1", "--logdir", f"{workdir}/sd3",
                          "--num-fsdp", "1", "--loader", "native"])
    out["losses"] = {"finetune": [m["loss"] for m in ft["metrics"]],
                     "sd3": [m["loss"] for m in sd3["metrics"]]}
    out["sd3_mesh"] = tuple(sd3["mesh"].shape)
    out["fid"] = fid.main(["ref", "--images", inputs["png_dir"], "--out", f"{workdir}/fid.npz",
                           "--batch", "3", "--device", "cpu", "--sharded"])
    try:
        train_sd15.main(base[:base.index("--batch-size")] + ["--batch-size", "3"]
                        + base[base.index("--resolution"):] + ["--logdir", f"{workdir}/c"])
    except SystemExit as e:
        out["refusal"] = str(e)
    return out
