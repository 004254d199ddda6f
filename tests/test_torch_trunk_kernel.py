"""The port's trunk megakernel and its compositions against the JAX package's.

On the CPU the port's wrapper runs its plain version.  Each segment is held
to the Pallas megakernel in interpret mode at atol and rtol 1e-4 (f32 sums
taken in another order); the fused, split and split3 compositions to the
Pallas compositions and to flax ``apply_inference`` at 2e-5.  Both packages
get the same weights (``from_flax_variables``) and the same numpy-seeded
inputs.  The CUDA kernel against the plain version is in
test_torch_cuda_kernel.py, which needs no JAX.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepbinner_tpu.models import network as jax_network
from deepbinner_tpu.models import pallas_apply
from deepbinner_tpu.models.checkpoint import load_model as jax_load_model
from deepbinner_tpu_torch.models import kernel_apply
from deepbinner_tpu_torch.models.checkpoint import model_from_flax_variables
from deepbinner_tpu_torch.models.kernel_apply import fold_network
from deepbinner_tpu_torch.models.network import NetworkConfig
from deepbinner_tpu_torch.ops import trunk_kernel
from deepbinner_tpu_torch.ops.trunk_kernel import (
    SEGMENTS,
    mega_unit_scopes,
    segment_input_channels,
    segment_spec,
    trunk_segment,
    trunk_segment_reference,
)

DATA = os.path.join(os.path.dirname(__file__), "..", "deepbinner_tpu",
                    "models", "data")
CPU = torch.device("cpu")
CONFIGS = {
    "tiny": dict(input_length=256, stem_features=8, block_features=(8,),
                 inception_features=(16,), head_features=16),
    # The flagship shape (2 blocks, 2 inceptions) at narrow widths.
    "flagship_shaped": dict(input_length=512, stem_features=16,
                            block_features=(16, 32),
                            inception_features=(32, 32), head_features=32),
}
COMPOSITIONS = {
    "fused": (kernel_apply.apply_inference_kernels_fused,
              pallas_apply.apply_inference_pallas_fused),
    "split": (kernel_apply.apply_inference_kernels_split,
              pallas_apply.apply_inference_pallas_split),
    "split3": (kernel_apply.apply_inference_kernels_split3,
               pallas_apply.apply_inference_pallas_split3),
}


def _both(name, seed):
    """(flax model, variables, port FoldedNet, port config) of one config."""
    jax_cfg = jax_network.NetworkConfig(**CONFIGS[name])
    cfg = NetworkConfig(**CONFIGS[name])
    model, variables = jax_network.init_params(jax.random.PRNGKey(seed), jax_cfg)
    variables = jax.device_get(variables)
    net = fold_network(model_from_flax_variables(cfg, variables), CPU)
    return model, variables, net, cfg


@pytest.fixture(scope="module")
def flagship_shaped():
    return _both("flagship_shaped", 3)


def _segment_input(cfg, segment, n, seed):
    early, inc_lo, _hi, _head = segment_spec(cfg, segment)
    length = cfg.input_length
    if not early:
        length //= 2 ** (1 + len(cfg.block_features) + inc_lo)
    return np.random.default_rng(seed).normal(
        size=(n, length, segment_input_channels(cfg, segment))).astype(np.float32)


@pytest.mark.parametrize("segment", SEGMENTS)
def test_segment_matches_pallas_interpret(flagship_shaped, segment):
    """N = 11: no Pallas batch tile (4) divides it."""
    _model, variables, net, cfg = flagship_shaped
    x = _segment_input(cfg, segment, 11, seed=len(segment))
    want = pallas_apply._run_segment(
        jax_network.NetworkConfig(**CONFIGS["flagship_shaped"]),
        variables["params"], variables["batch_stats"], jnp.asarray(x),
        segment, tile_n=4, interpret=True, mxu_dtype=jnp.float32)
    got = trunk_segment(torch.from_numpy(x), net.trunk, cfg, segment)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("segment", SEGMENTS)
def test_segment_output_shape(flagship_shaped, segment):
    """The shape the CUDA wrapper allocates is the plain version's."""
    _model, _variables, net, cfg = flagship_shaped
    x = torch.from_numpy(_segment_input(cfg, segment, 3, seed=1))
    want = trunk_segment_reference(x, net.units, cfg, segment).shape
    assert trunk_kernel.segment_output_shape(cfg, segment, *x.shape[:2]) == want


@pytest.mark.parametrize("name", ["tiny", "flagship_shaped", "flagship"])
@pytest.mark.parametrize("segment", SEGMENTS)
def test_segment_tables_match_jax(name, segment):
    fields = CONFIGS.get(name, {})
    jax_cfg = jax_network.NetworkConfig(**fields)
    cfg = NetworkConfig(**fields)
    assert segment_spec(cfg, segment) == pallas_apply._segment_spec(jax_cfg,
                                                                    segment)
    assert mega_unit_scopes(cfg, segment) == \
        pallas_apply._mega_unit_scopes(jax_cfg, segment)


@pytest.mark.parametrize("name,seed,batch", [("tiny", 1, 5),
                                             ("flagship_shaped", 3, 11)])
@pytest.mark.parametrize("composition", sorted(COMPOSITIONS))
def test_composition_matches_pallas_and_flax(name, seed, batch, composition):
    """Tiny split3 ends on a late1 segment with no inception: head only."""
    model, variables, net, cfg = _both(name, seed)
    port_apply, pallas_fn = COMPOSITIONS[composition]
    x = np.random.default_rng(seed).normal(
        size=(batch, cfg.input_length)).astype(np.float32)
    want = np.asarray(jax_network.apply_inference(model, variables,
                                                  jnp.asarray(x)))
    pallas = np.asarray(pallas_fn(jax_network.NetworkConfig(**CONFIGS[name]),
                                  variables, jnp.asarray(x), interpret=True))
    got = port_apply(net, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(got, pallas, atol=2e-5)


def test_fused_full_width_stock_model():
    model, variables, jax_cfg, _meta = jax_load_model(
        os.path.join(DATA, "EXP-NBD103_read_starts.dbt"))
    fields = {k: getattr(jax_cfg, k) for k in NetworkConfig.__dataclass_fields__}
    cfg = NetworkConfig(**fields)
    x = np.random.default_rng(5).normal(
        size=(3, cfg.input_length)).astype(np.float32)
    want = np.asarray(jax_network.apply_inference(model, variables,
                                                  jnp.asarray(x)))
    net = fold_network(model_from_flax_variables(cfg, variables), CPU)
    got = kernel_apply.apply_inference_kernels_fused(
        net, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_cpu_wrapper_is_the_plain_version_and_counts_nothing(flagship_shaped):
    _model, _variables, net, cfg = flagship_shaped
    x = torch.from_numpy(_segment_input(cfg, "all", 2, seed=0))
    before = trunk_kernel.LAUNCHES
    got = trunk_segment(x, net.trunk, cfg, "all")
    assert torch.equal(got, trunk_segment_reference(x, net.units, cfg, "all"))
    assert trunk_kernel.LAUNCHES == before


def test_pack_trunk_offsets(flagship_shaped):
    """Each unit's kernel, scale and bias sit at its offsets, back to back,
    each kernel 16-byte aligned."""
    _model, _variables, net, cfg = flagship_shaped
    at = 0
    for scope, _dilation in mega_unit_scopes(cfg, "all"):
        kernel, scale, bias = net.units[scope]
        kernel_at, scale_at = net.trunk.offsets[scope]
        at += -at % 4
        assert (kernel_at, scale_at) == (at, at + kernel.numel())
        params = net.trunk.params
        assert torch.equal(params[kernel_at:scale_at].reshape(kernel.shape),
                           kernel)
        c_out = scale.numel()
        assert torch.equal(params[scale_at:scale_at + c_out], scale)
        assert torch.equal(params[scale_at + c_out:scale_at + 2 * c_out], bias)
        at = scale_at + 2 * c_out
    assert at == net.trunk.params.numel()
    assert "stem1" not in net.trunk.offsets


@pytest.mark.parametrize("segment,shape,error", [
    ("all", (2, 512, 15), ValueError),    # stem2 takes 16 channels
    ("early", (2, 100, 16), ValueError),  # 3 pools: L must divide by 8
    ("late", (2, 64), ValueError),        # not (N, L, C)
    ("middle", (2, 64, 32), ValueError),  # no such segment
])
def test_rejects_bad_input(flagship_shaped, segment, shape, error):
    _model, _variables, net, cfg = flagship_shaped
    with pytest.raises(error):
        trunk_segment(torch.zeros(shape), net.trunk, cfg, segment)
