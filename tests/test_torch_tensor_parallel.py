"""PyTorch port, tensor parallelism of the SD3 MMDiT and ControlNet
(`parallel/tensor_parallel.py`): the JointBlocks split over a tensor
width of 2 on two gloo ranks (`tests/torch_dist_util.py`) against JAX's
unsharded forward at fp32, within `tests/test_tensor_parallel.py`'s
bounds (rtol 2e-5, atol 1e-5); the rule table against the JAX package's;
the refusals (int8, heads the width does not divide)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prompt_diffusion_tpu.models import controlnet_sd3 as jcn3
from prompt_diffusion_tpu.models import mmdit_sd3 as jmm
from prompt_diffusion_tpu.parallel import tensor_parallel as jtp
from prompt_diffusion_tpu.utils.dtypes import fp32_policy as j_fp32_policy
from prompt_diffusion_tpu_torch.models.controlnet_sd3 import SD3ControlNet
from prompt_diffusion_tpu_torch.models.mmdit_sd3 import MMDiTConfig, SD3Transformer
from prompt_diffusion_tpu_torch.parallel import tensor_parallel as tp
from prompt_diffusion_tpu_torch.tools.jax_bridge import state_dict_from_jax
from prompt_diffusion_tpu_torch.utils.dtypes import DTypePolicy, fp32_policy
from tests import torch_dist_util as du
from tests.torch_port_util import randomize

torch.set_num_threads(2)

TCFG = du.TCFG
B, LAT, L = 2, 8, 10


@pytest.fixture(scope="module")
def forwards(tmp_path_factory):
    """JAX's unsharded MMDiT and ControlNet forwards and the port's on two
    ranks with `apply_tp`, from one set of random weights and inputs."""
    cfg = jmm.MMDiTConfig(**TCFG)
    jtr = jmm.SD3Transformer(config=cfg, policy=j_fp32_policy())
    jcn = jcn3.SD3ControlNet(config=cfg, policy=j_fp32_policy())
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
    ref = {"transformer": np.asarray(jtr.apply(params["transformer"], ja["lat"], ja["t"],
                                               ja["ctx"], ja["pooled"])),
           "controlnet": [np.asarray(a) for a in jcn.apply(
               params["controlnet"], ja["lat"], ja["t"], ja["lat"], ja["lat"], ja["ctx"],
               ja["pooled"])]}
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
    """int8 (K10 and K11 scale whole rows) and heads the width does not
    divide are refused before anything changes; a width of 1 leaves the
    module as it is."""
    int8 = SD3Transformer(MMDiTConfig(**TCFG),
                          DTypePolicy(compute_dtype=torch.float32, quant="int8"))
    with pytest.raises(NotImplementedError, match="int8 tensor parallelism"):
        tp.apply_tp(int8, _Mesh(2))
    cn = SD3ControlNet(MMDiTConfig(**TCFG), fp32_policy())
    before = {k: v.clone() for k, v in cn.state_dict().items()}
    with pytest.raises(ValueError, match="4 heads do not divide over a tensor width of 3"):
        tp.apply_tp(cn, _Mesh(3))
    assert tp.apply_tp(cn, _Mesh(1)) is cn
    after = cn.state_dict()
    assert after.keys() == before.keys() and all(torch.equal(after[k], before[k]) for k in before)
    assert cn.blocks_0.heads == TCFG["num_attention_heads"]
