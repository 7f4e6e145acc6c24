"""PyTorch port, tensor parallelism of the SD3 MMDiT and ControlNet
(`parallel/tensor_parallel.py`): the JointBlocks split over a tensor
width of 2 on two gloo ranks (`tests/torch_dist_util.py`) against JAX's
unsharded forward at fp32, within `tests/test_tensor_parallel.py`'s
bounds (rtol 2e-5, atol 1e-5), and under the int8 policy (fp32 compute)
bit-equal to the port's unsharded int8 forward and at JAX int8's noise
level (the rule of `tests/test_torch_sd3.py::
test_int8_transformer_at_jax_noise_level`); the rule table against the
JAX package's; K10 and K11 split over a tensor group (`ops/fused_act.py::
split_act_quant`): the plain passes bit-equal to the one-launch plain
versions, and the launchers of the card's passes against an extension
stand-in; the refusal of heads the width does not divide."""

import contextlib
import ctypes
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prompt_diffusion_tpu.models import controlnet_sd3 as jcn3
from prompt_diffusion_tpu.models import mmdit_sd3 as jmm
from prompt_diffusion_tpu.parallel import tensor_parallel as jtp
from prompt_diffusion_tpu.utils.dtypes import DTypePolicy as JPolicy
from prompt_diffusion_tpu.utils.dtypes import fp32_policy as j_fp32_policy
from prompt_diffusion_tpu_torch.models.controlnet_sd3 import SD3ControlNet
from prompt_diffusion_tpu_torch.models.mmdit_sd3 import MMDiTConfig, SD3Transformer
from prompt_diffusion_tpu_torch.ops import fused_act
from prompt_diffusion_tpu_torch.ops import row_quant as rq
from prompt_diffusion_tpu_torch.ops.fused_layer_norm import rowquant_amax
from prompt_diffusion_tpu_torch.parallel import tensor_parallel as tp
from prompt_diffusion_tpu_torch.tools.jax_bridge import state_dict_from_jax
from prompt_diffusion_tpu_torch.utils.dtypes import fp32_policy
from tests import torch_dist_util as du
from tests.torch_port_util import randomize

torch.set_num_threads(2)

TCFG = du.TCFG
B, LAT, L = 2, 8, 10
J_INT8_F32 = JPolicy(compute_dtype=jnp.float32, quant="int8")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def forwards(tmp_path_factory):
    """JAX's unsharded MMDiT and ControlNet forwards (fp32 and int8) and
    the port's on two ranks with `apply_tp` (fp32, int8 and the unsharded
    int8), from one set of random weights and inputs."""
    cfg = jmm.MMDiTConfig(**TCFG)
    jtr = jmm.SD3Transformer(config=cfg, policy=j_fp32_policy())
    jcn = jcn3.SD3ControlNet(config=cfg, policy=j_fp32_policy())
    jtr8 = jmm.SD3Transformer(config=cfg, policy=J_INT8_F32)
    jcn8 = jcn3.SD3ControlNet(config=cfg, policy=J_INT8_F32)
    k = jax.random.PRNGKey(0)
    lat, t = jnp.zeros((B, LAT, LAT, 4)), jnp.zeros((B,))
    ctx, pooled = jnp.zeros((B, L, 64)), jnp.zeros((B, 56))
    params = randomize({"transformer": jax.eval_shape(jtr.init, k, lat, t, ctx, pooled),
                        "controlnet": jax.eval_shape(jcn.init, k, lat, t, lat, lat, ctx,
                                                     pooled)}, 70)
    g = np.random.default_rng(0)
    x = {"lat": g.normal(size=(B, LAT, LAT, 4)).astype(np.float32),
         "t": np.asarray([250.0, 875.0], np.float32),
         "ctx": g.normal(size=(B, L, 64)).astype(np.float32),
         "pooled": g.normal(size=(B, 56)).astype(np.float32)}
    ja = {k: jnp.asarray(v) for k, v in x.items()}
    run_tr = lambda m: np.asarray(m.apply(params["transformer"], ja["lat"], ja["t"], ja["ctx"],
                                          ja["pooled"]))
    run_cn = lambda m: [np.asarray(a) for a in m.apply(
        params["controlnet"], ja["lat"], ja["t"], ja["lat"], ja["lat"], ja["ctx"], ja["pooled"])]
    ref = {"transformer": run_tr(jtr), "controlnet": run_cn(jcn),
           "int8": {"transformer": run_tr(jtr8), "controlnet": run_cn(jcn8)}}
    nchw = torch.from_numpy(x["lat"]).permute(0, 3, 1, 2).contiguous()
    inputs = {"transformer": state_dict_from_jax(params["transformer"]),
              "controlnet": state_dict_from_jax(params["controlnet"]),
              "x": {"lat": nchw, "t": torch.from_numpy(x["t"]),
                    "ctx": torch.from_numpy(x["ctx"]), "pooled": torch.from_numpy(x["pooled"])}}
    ranks = du.spawn(du.tp_worker, 2, str(tmp_path_factory.mktemp("tp")), inputs)
    return ref, ranks, inputs


def test_mmdit_tp_forward_matches_jax(forwards):
    ref, ranks, _ = forwards
    for r in ranks:
        assert r["heads"] == TCFG["num_attention_heads"] // 2
        assert r["to_q_rows"] == TCFG["num_attention_heads"] * TCFG["attention_head_dim"] // 2
        out = r["transformer"].permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(out, ref["transformer"], rtol=2e-5, atol=1e-5)


def test_sd3_controlnet_tp_forward_matches_jax(forwards):
    ref, ranks, _ = forwards
    assert max(np.abs(a).max() for a in ref["controlnet"]) > 0
    for r in ranks:
        assert len(r["controlnet"]) == len(ref["controlnet"])
        for a, b in zip(r["controlnet"], ref["controlnet"]):
            np.testing.assert_allclose(a.numpy(), b, rtol=2e-5, atol=1e-5)


def _flat(out):
    """A forward's output as one fp32 array (the ControlNet's taps
    concatenated), NHWC for the transformer's latents."""
    if isinstance(out, (list, tuple)):
        return np.concatenate([np.asarray(a).reshape(-1) for a in out])
    a = out.permute(0, 2, 3, 1).numpy() if isinstance(out, torch.Tensor) else out
    return np.asarray(a).reshape(-1)


@pytest.mark.parametrize("model", ["transformer", "controlnet"])
def test_int8_tp_forward_bit_equal_to_unsharded(forwards, model):
    """Under the int8 policy at tensor width 2 each rank's forward equals
    the unsharded port's bit for bit: the column-sharded codes are the
    whole weight's rows, K10 and K11 take the row amax over both ranks,
    and the row-sharded layers sum int32 accumulators before the one
    dequantization."""
    _, ranks, _ = forwards
    for r in ranks:
        got, want = r["int8"][model], r["int8_unsharded"][model]
        if model == "transformer":
            assert torch.equal(got, want)
        else:
            assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
    assert np.array_equal(_flat(ranks[0]["int8"][model]), _flat(ranks[1]["int8"][model]))


@pytest.mark.parametrize("model", ["transformer", "controlnet"])
def test_int8_tp_forward_at_jax_noise_level(forwards, model):
    """The int8 TP forward (rank 0's; fp32 compute) as far from JAX fp32
    as JAX int8 is (ratio within [0.5, 1.5]) and no farther from JAX int8
    than 1.5 times that: the rule of tests/test_torch_sd3.py::
    test_int8_transformer_at_jax_noise_level."""
    ref, ranks, _ = forwards
    got = _flat(ranks[0]["int8"][model])
    ref8, ref32 = _flat(ref["int8"][model]), _flat(ref[model])
    quant_err = _rel(ref8, ref32)
    ratio32, ratio8 = _rel(got, ref32) / quant_err, _rel(got, ref8) / quant_err
    assert quant_err > 1e-3, quant_err
    assert 0.5 <= ratio32 <= 1.5 and ratio8 <= 1.5, (quant_err, ratio32, ratio8)


def test_int8_tp_splits_k10_and_k11_over_the_group(forwards):
    """The int8 forwards at width 2 quantize every row-sharded layer's
    input split over the group of 2: K11 at `to_out` and `to_add_out`
    (C / 2 = 32 columns a rank), K10 at `ff_out` and `ff_context_out`
    (4C / 2 = 128): 4 a JointBlock, 2 in the MMDiT's last
    (context_pre_only) one; 2 MMDiT and 2 ControlNet blocks."""
    _, ranks, _ = forwards
    c = TCFG["num_attention_heads"] * TCFG["attention_head_dim"]
    for r in ranks:
        calls = r["split_calls"]
        assert sorted(set(calls)) == [(c // 2, False, 2), (4 * c // 2, True, 2)]
        assert calls.count((c // 2, False, 2)) == calls.count((4 * c // 2, True, 2)) == 3 + 4


def test_rules_copy_the_jax_table():
    kind = {jtp._COL: "col", jtp._ROW: "row"}
    assert tp.TP_RULES == {k: kind[v] for k, v in jtp._TP_KERNEL_RULES.items()}


class _Mesh:
    """A ('data', 'tensor') mesh's shape, for the checks `apply_tp` makes
    before it touches a process group."""

    mesh_dim_names = ("data", "tensor")

    def __init__(self, tensor):
        self.tensor = tensor

    def size(self, dim=None):
        return self.tensor if dim == 1 else 1


def test_apply_tp_refusals():
    """Heads the width does not divide are refused before anything
    changes; a width of 1 leaves the module as it is, under the int8
    policy too (which is no longer refused: the int8 tests above)."""
    int8 = SD3Transformer(MMDiTConfig(**TCFG), du.INT8_F32)
    before8 = {k: v.clone() for k, v in int8.state_dict().items()}
    assert tp.apply_tp(int8, _Mesh(1)) is int8
    assert int8.blocks_0.tp_group is None
    assert all(torch.equal(v, before8[k]) for k, v in int8.state_dict().items())
    cn = SD3ControlNet(MMDiTConfig(**TCFG), fp32_policy())
    before = {k: v.clone() for k, v in cn.state_dict().items()}
    with pytest.raises(ValueError, match="4 heads do not divide over a tensor width of 3"):
        tp.apply_tp(cn, _Mesh(3))
    assert tp.apply_tp(cn, _Mesh(1)) is cn
    after = cn.state_dict()
    assert after.keys() == before.keys() and all(torch.equal(after[k], before[k]) for k in before)
    assert cn.blocks_0.heads == TCFG["num_attention_heads"]


# ---- K10 and K11 split over a tensor group ---------------------------------


def _rows_input(rng, shape, dtype):
    """Activations with a spread of row maxima (a few rows 20x larger), as
    the attention output and the feed-forward's hidden units have."""
    x = rng.normal(size=shape) * np.where(rng.random(shape[:-1] + (1,)) < 0.1, 20.0, 1.0)
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cut", [1, 2, 4])
@pytest.mark.parametrize("gelu", [True, False], ids=["k10", "k11"])
def test_split_act_quant_plain_matches_one_launch(gelu, cut, dtype):
    """The plain split K10 / K11 (`act_amax` on each of `cut` column
    slices, their maximum standing for the group's all-reduce, `act_codes`
    on each slice) against the one-launch plain versions on the whole
    rows: codes and scales bit-equal. With one slice it is
    `split_act_quant` with no group, a group of one rank."""
    rng = np.random.default_rng(7 + cut)
    x = _rows_input(rng, (2, 9, 256), dtype)
    one = fused_act.fused_gelu_quant if gelu else fused_act.fused_quant_rows
    want_q, want_s = one(x)
    if cut == 1:
        got_q, got_s = fused_act.split_act_quant(x, gelu)
        assert torch.equal(got_q, want_q) and torch.equal(got_s, want_s)
        return
    parts = x.chunk(cut, dim=-1)
    amax = torch.stack([fused_act.act_amax(p, gelu) for p in parts]).amax(dim=0)
    assert amax.shape == (2, 9, 1) and amax.dtype == torch.float32
    outs = [fused_act.act_codes(p, amax, gelu) for p in parts]
    assert torch.equal(torch.cat([q for q, _ in outs], dim=-1), want_q)
    for _, s in outs:
        assert torch.equal(s, want_s)
    # a slice's own amax (no exchange) gives other codes where another
    # slice holds the row's maximum
    local = [rowquant_amax(fused_act._torch_act(p, gelu), fused_act.act_amax(p, gelu))[0]
             for p in parts]
    assert not torch.equal(torch.cat(local, dim=-1), want_q)


class _SplitExt:
    """Stands in for the extension's `row_quant` at the split ops (6-9): does
    their work on host memory through the pointers and element strides it
    is given, each row of each sample once, with the plain functions; the
    one-group plan the split passes launch with."""

    def __init__(self):
        self.calls = []

    def row_quant(self, op, x, x_bf16, x_sb, x_sn, batch, n, c, sc, sc_bf16, sc_sb, sc_sc, sh,
                  sh_bf16, sh_sb, sh_sc, eps, tpr, vpt, groups, grid_x, codes, scales, stream):
        self.calls.append(dict(op=op, x=x, x_sb=x_sb, x_sn=x_sn, batch=batch, n=n, c=c, sc=sc,
                               codes=codes, groups=groups))
        assert op in (rq.GELU_AMAX, rq.ROWS_AMAX, rq.GELU_CODES, rq.ROWS_CODES) and groups == 1
        assert tpr * vpt * rq.VEC_BYTES >= c * (2 if x_bf16 else 4)
        assert grid_x * (rq.BLOCK_THREADS // tpr) >= n
        dt = torch.bfloat16 if x_bf16 else torch.float32
        size = batch * x_sb if batch > 1 else n * x_sn
        raw = (ctypes.c_uint16 if x_bf16 else ctypes.c_float) * size
        flat = torch.frombuffer(raw.from_address(x), dtype=torch.int16 if x_bf16 else dt)
        flat = flat.view(dt) if x_bf16 else flat
        x_t = torch.as_strided(flat, (batch, n, c), (x_sb, x_sn, 1))
        gelu = op in (rq.GELU_AMAX, rq.GELU_CODES)
        out_s = torch.frombuffer((ctypes.c_float * (batch * n)).from_address(scales),
                                 dtype=torch.float32)
        if op in (rq.GELU_AMAX, rq.ROWS_AMAX):
            assert codes == 0
            out_s.copy_(fused_act._torch_act(x_t, gelu).abs().amax(dim=-1).reshape(-1))
            return
        amax = torch.frombuffer((ctypes.c_float * (batch * n)).from_address(sc),
                                dtype=torch.float32)
        q, s = rowquant_amax(fused_act._torch_act(x_t, gelu), amax.view(batch, n, 1))
        torch.frombuffer((ctypes.c_int8 * (batch * n * c)).from_address(codes),
                         dtype=torch.int8).copy_(q.reshape(-1))
        out_s.copy_(s.reshape(-1))


@pytest.fixture
def split_ext(monkeypatch):
    """The stand-in extension, and CUDA's device and stream context as
    no-ops, so that the split launchers run on CPU tensors."""
    from prompt_diffusion_tpu_torch.ops import _build

    stand_in = _SplitExt()
    monkeypatch.setattr(_build, "cuda_ext", lambda: stand_in)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return stand_in


@pytest.mark.parametrize("part", ["image", "context", "hidden"])
def test_split_launchers_read_rows_in_place(part, split_ext):
    """`row_amax` then `codes_from_amax` on a rank's K11 input (the slices
    `attn[:, :n_h]` and `attn[:, n_h:]` of one packed (B, N_h + N_c, C)
    attention output, read in place with its sample stride) or K10 input
    (a dense (B, N, 4C) hidden): one call of ops 6 / 7 and one of ops 8 / 9
    each, with the input's own pointer and strides, a one-group plan, the
    amax vector handed over as `sc`; the result the plain split's."""
    rng = np.random.default_rng(3)
    if part == "hidden":
        x, gelu = _rows_input(rng, (2, 24, 128), torch.bfloat16), True
    else:
        attn = _rows_input(rng, (2, 24 + 8, 64), torch.bfloat16)
        x, gelu = (attn[:, :24] if part == "image" else attn[:, 24:]), False
    amax = rq.row_amax(x, gelu)
    q, s = rq.codes_from_amax(x, amax, gelu)
    a, b = split_ext.calls
    assert (a["op"], b["op"]) == ((rq.GELU_AMAX, rq.GELU_CODES) if gelu
                                  else (rq.ROWS_AMAX, rq.ROWS_CODES))
    for call in (a, b):
        assert (call["x"], call["x_sb"], call["x_sn"]) == (x.data_ptr(), x.stride(0),
                                                           x.stride(1))
        assert (call["batch"], call["n"], call["c"]) == tuple(x.shape)
    assert b["sc"] == amax.data_ptr() and amax.shape == (*x.shape[:-1], 1)
    assert torch.equal(amax, fused_act._torch_act(x, gelu).abs().amax(dim=-1, keepdim=True))
    want_q, want_s = (fused_act.fused_gelu_quant if gelu else fused_act.fused_quant_rows)(x)
    assert torch.equal(q, want_q) and torch.equal(s, want_s)


@pytest.mark.parametrize("bad", ["dtype", "size", "layout"])
def test_codes_from_amax_refuses_before_build(bad, monkeypatch):
    """An amax that is not one dense fp32 value a row is refused with a
    ValueError before the extension is built or a launch queued."""
    from prompt_diffusion_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "cuda_ext", lambda: pytest.fail("built"))
    x = torch.zeros((2, 8, 64), dtype=torch.bfloat16)
    amax = {"dtype": torch.zeros((2, 8, 1), dtype=torch.bfloat16),
            "size": torch.zeros((2, 7, 1)),
            "layout": torch.zeros((2, 8, 2))[..., :1]}[bad]
    with pytest.raises(ValueError, match="amax must be 16 dense fp32 values"):
        rq.codes_from_amax(x, amax, gelu=False)
