"""``ops/nn_extra.py``, the resize / rearrangement / sampling half of
``ops/nn.py`` and ``nn.SpectralNorm`` of the port against the JAX
package's, on the CPU: one case per function, the same numpy-seeded
inputs through both (the JAX side jitted), float outputs within atol
1e-5 + rtol 1e-5 (integer outputs equal) and the gradients of a fixed
random projection within 1e-5.

The cases hold what a plain torch port gets wrong:
- ``jax.image.resize``: nearest with half-pixel centres (torch's
  ``"nearest-exact"``, not ``"nearest"``) and linear with antialiasing
  when downsampling, both up and down, square and not;
- the pools with index: the first maximum of a window wins (ties
  included), a padded window; the custom gradient (the cotangent
  scattered to the argmax), and ``unpool``'s adds at repeated indices;
- the transposed convolutions: XLA's ``conv_transpose`` does not flip
  the kernel;
- ``grid_sampler`` with samples off the map (the clipped gathers),
  ``similarity_focus`` with ties along a row."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.ops import nn as JN
from paddle_tpu.ops import nn_extra as J
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.ops import nn as TN
from paddle_tpu_torch.ops import nn_extra as T
from paddle_tpu_torch.utils.convert import load_numpy_state
from torch_parity import check_pair

RNG = np.random.default_rng(13)
P = functools.partial


def f32(*shape):
    return RNG.normal(size=shape).astype(np.float32)


TIED = np.array([[[[1.0, 3.0, 3.0, 0.0], [3.0, 2.0, 1.0, 1.0],
                   [0.0, 0.0, 5.0, 5.0], [0.0, -1.0, 5.0, 4.0]]]],
                np.float32)
POOL_IDX = np.array([[[[0, 5, 5], [15, 3, 3]]]], np.int32)

# name -> (JAX fn, port fn, args, grad positions)
CASES = {
    "interpolate_nearest_up": (P(JN.interpolate, size=(7, 10)),
                               P(TN.interpolate, size=(7, 10)),
                               [f32(2, 3, 4, 5)], (0,)),
    "interpolate_nearest_down": (P(JN.interpolate, size=(3, 2)),
                                 P(TN.interpolate, size=(3, 2)),
                                 [f32(2, 3, 7, 5)], (0,)),
    "interpolate_bilinear_up": (P(JN.interpolate, size=(9, 7),
                                  method="bilinear"),
                                P(TN.interpolate, size=(9, 7),
                                  method="bilinear"),
                                [f32(2, 3, 4, 5)], (0,)),
    "interpolate_bilinear_down": (P(JN.interpolate, size=(3, 4),
                                    method="bilinear"),
                                  P(TN.interpolate, size=(3, 4),
                                    method="bilinear"),
                                  [f32(2, 3, 8, 11)], (0,)),
    "interpolate_bilinear_mixed": (P(JN.interpolate, size=(12, 2),
                                     method="bilinear"),
                                   P(TN.interpolate, size=(12, 2),
                                     method="bilinear"),
                                   [f32(1, 2, 5, 9)], (0,)),
    "pixel_shuffle": (P(JN.pixel_shuffle, upscale_factor=2),
                      P(TN.pixel_shuffle, upscale_factor=2),
                      [f32(2, 8, 3, 4)], (0,)),
    "pad2d_constant": (P(JN.pad2d, paddings=(1, 2, 0, 3), value=0.5),
                       P(TN.pad2d, paddings=(1, 2, 0, 3), value=0.5),
                       [f32(2, 3, 4, 5)], (0,)),
    "pad2d_reflect": (P(JN.pad2d, paddings=(2, 1, 3, 0), mode="reflect"),
                      P(TN.pad2d, paddings=(2, 1, 3, 0), mode="reflect"),
                      [f32(2, 3, 4, 5)], (0,)),
    "pad2d_edge": (P(JN.pad2d, paddings=(2, 1, 3, 2), mode="edge"),
                   P(TN.pad2d, paddings=(2, 1, 3, 2), mode="edge"),
                   [f32(2, 3, 4, 5)], (0,)),
    "space_to_depth": (P(JN.space_to_depth, blocksize=2),
                       P(TN.space_to_depth, blocksize=2),
                       [f32(2, 3, 4, 6)], (0,)),
    "shuffle_channel": (P(JN.shuffle_channel, group=3),
                        P(TN.shuffle_channel, group=3),
                        [f32(2, 6, 3, 4)], (0,)),
    "grid_sampler": (JN.grid_sampler, TN.grid_sampler,
                     [f32(2, 3, 5, 6), (RNG.uniform(-1.3, 1.3, (2, 4, 3, 2))
                                        .astype(np.float32))], (0, 1)),
    "temporal_shift": (P(JN.temporal_shift, seg_num=3, shift_ratio=0.25),
                       P(TN.temporal_shift, seg_num=3, shift_ratio=0.25),
                       [f32(6, 8, 2, 3)], (0,)),
    "pool3d_max": (P(J.pool3d, kernel_size=2, stride=(1, 2, 2), padding=1),
                   P(T.pool3d, kernel_size=2, stride=(1, 2, 2), padding=1),
                   [f32(2, 3, 4, 5, 6)], (0,)),
    "pool3d_avg": (P(J.pool3d, kernel_size=(2, 3, 3), pool_type="avg",
                     padding=(1, 1, 2)),
                   P(T.pool3d, kernel_size=(2, 3, 3), pool_type="avg",
                     padding=(1, 1, 2)),
                   [f32(2, 3, 4, 5, 6)], (0,)),
    "pool3d_global": (P(J.pool3d, kernel_size=1, global_pooling=True),
                      P(T.pool3d, kernel_size=1, global_pooling=True),
                      [f32(2, 3, 3, 4, 2)], (0,)),
    "max_pool2d_with_index": (P(J.max_pool2d_with_index, kernel_size=2),
                              P(T.max_pool2d_with_index, kernel_size=2),
                              [f32(2, 3, 6, 8)], (0,)),
    "max_pool2d_with_index_ties_padded": (
        P(J.max_pool2d_with_index, kernel_size=3, stride=2, padding=1),
        P(T.max_pool2d_with_index, kernel_size=3, stride=2, padding=1),
        [TIED], (0,)),
    "max_pool2d_with_index_overlap": (
        P(J.max_pool2d_with_index, kernel_size=(3, 2), stride=1),
        P(T.max_pool2d_with_index, kernel_size=(3, 2), stride=1),
        [TIED], (0,)),
    "max_pool3d_with_index": (P(J.max_pool3d_with_index, kernel_size=2,
                                padding=(0, 1, 1)),
                              P(T.max_pool3d_with_index, kernel_size=2,
                                padding=(0, 1, 1)),
                              [f32(2, 2, 4, 4, 5)], ()),
    "unpool": (P(J.unpool, output_size=(4, 4)),
               P(T.unpool, output_size=(4, 4)),
               [f32(1, 1, 2, 3), POOL_IDX], (0,)),
    "spp": (P(J.spp, pyramid_height=3), P(T.spp, pyramid_height=3),
            [f32(2, 3, 7, 9)], (0,)),
    "spp_avg": (P(J.spp, pyramid_height=2, pool_type="avg"),
                P(T.spp, pyramid_height=2, pool_type="avg"),
                [f32(2, 3, 5, 6)], (0,)),
    "affine_channel": (J.affine_channel, T.affine_channel,
                       [f32(2, 3, 4, 5), f32(3), f32(3)], (0, 1, 2)),
    "affine_channel_nhwc": (P(J.affine_channel, data_layout="NHWC"),
                            P(T.affine_channel, data_layout="NHWC"),
                            [f32(2, 4, 5, 3), f32(3), f32(3)], (0, 1, 2)),
    "affine_grid": (P(J.affine_grid, out_shape=(2, 3, 4, 5)),
                    P(T.affine_grid, out_shape=(2, 3, 4, 5)),
                    [f32(2, 2, 3)], (0,)),
    "conv3d_transpose": (lambda x, w, b: J.conv3d_transpose(
                             x, w, stride=2, padding=1, bias=b),
                         lambda x, w, b: T.conv3d_transpose(
                             x, w, stride=2, padding=1, bias=b),
                         [f32(2, 3, 3, 4, 3), f32(3, 2, 3, 3, 2), f32(2)],
                         (0, 1, 2)),
    "depthwise_conv2d_transpose": (
        lambda x, w, b: J.depthwise_conv2d_transpose(
            x, w, stride=(2, 1), padding=(1, 0), bias=b),
        lambda x, w, b: T.depthwise_conv2d_transpose(
            x, w, stride=(2, 1), padding=(1, 0), bias=b),
        [f32(2, 3, 4, 5), f32(3, 1, 3, 2), f32(3)], (0, 1, 2)),
    "data_norm": (J.data_norm, T.data_norm,
                  [f32(4, 3), np.full((3,), 10.0, np.float32), f32(3) * 10,
                   RNG.uniform(20, 30, (3,)).astype(np.float32)], (0, 2, 3)),
    "bilinear_interp": (P(J.bilinear_interp, out_size=(6, 3)),
                        P(T.bilinear_interp, out_size=(6, 3)),
                        [f32(2, 2, 4, 5)], (0,)),
    "nearest_interp": (P(J.nearest_interp, out_size=(3, 8)),
                       P(T.nearest_interp, out_size=(3, 8)),
                       [f32(2, 2, 4, 5)], (0,)),
    "fsp_matrix": (J.fsp_matrix, T.fsp_matrix,
                   [f32(2, 3, 4, 5), f32(2, 2, 4, 5)], (0, 1)),
    "similarity_focus": (P(J.similarity_focus, axis=1, indexes=[0, 2]),
                         P(T.similarity_focus, axis=1, indexes=[0, 2]),
                         [np.concatenate([TIED.repeat(2, 1),
                                          f32(1, 1, 4, 4)], 1)], ()),
    "similarity_focus_axis3": (P(J.similarity_focus, axis=3, indexes=[1]),
                               P(T.similarity_focus, axis=3, indexes=[1]),
                               [f32(2, 3, 4, 5)], ()),
    "cvm": (J.cvm, T.cvm, [np.abs(f32(4, 5))], (0,)),
    "cvm_drop": (P(J.cvm, use_cvm=False), P(T.cvm, use_cvm=False),
                 [np.abs(f32(4, 5))], (0,)),
    "tree_conv": (P(J.tree_conv, max_depth=2), P(T.tree_conv, max_depth=2),
                  [f32(5, 3), (RNG.random((5, 5)) / 5).astype(np.float32),
                   f32(3, 3, 4)], (0, 1, 2)),
    "adaptive_pool3d": (P(J.adaptive_pool3d, output_size=(2, 1, 3)),
                        P(T.adaptive_pool3d, output_size=(2, 1, 3)),
                        [f32(2, 3, 4, 2, 6)], (0,)),
    "adaptive_pool3d_max": (P(J.adaptive_pool3d, output_size=2,
                              pool_type="max"),
                            P(T.adaptive_pool3d, output_size=2,
                              pool_type="max"),
                            [f32(2, 3, 4, 2, 6)], (0,)),
    "spectral_norm": (P(J.spectral_norm, dim=1, power_iters=2),
                      P(T.spectral_norm, dim=1, power_iters=2),
                      [f32(4, 6, 2), f32(6), f32(8)], (0,)),
    "image_resize_short": (P(J.image_resize_short, out_short_len=3),
                           P(T.image_resize_short, out_short_len=3),
                           [f32(2, 3, 6, 9)], (0,)),
    "image_resize_short_nearest": (
        P(J.image_resize_short, out_short_len=7, method="nearest"),
        P(T.image_resize_short, out_short_len=7, method="nearest"),
        [f32(1, 2, 5, 4)], (0,)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_nn_extra_op_matches_jax(name):
    jfn, tfn, args, grad = CASES[name]
    check_pair(jfn, tfn, args, atol=1e-5, rtol=1e-5, grad=grad)


def test_resize_is_not_torch_interpolate():
    """The reason for writing the resize out: torch's plain nearest and
    non-antialiased bilinear differ from ``jax.image.resize``."""
    x = f32(1, 1, 7, 7)
    want = np.asarray(JN.interpolate(jnp.asarray(x), (3, 3), "bilinear"))
    plain = torch.nn.functional.interpolate(torch.from_numpy(x), (3, 3),
                                            mode="bilinear")
    assert np.abs(plain.numpy() - want).max() > 1e-3
    got = TN.interpolate(torch.from_numpy(x), (3, 3), "bilinear")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    up = np.asarray(JN.interpolate(jnp.asarray(x), (10, 10)))
    near = torch.nn.functional.interpolate(torch.from_numpy(x), (10, 10),
                                           mode="nearest")
    assert np.abs(near.numpy() - up).max() > 1e-3


def test_spectral_norm_layer_matches_jax_and_moves_its_buffers():
    """``SpectralNorm`` on the JAX layer's u/v buffers (carried across by
    name): the normalised weight within 1e-5, the training forward's new
    u and v too, and its gradient."""
    shape = (6, 4, 3)
    jl = jnn.SpectralNorm(shape, dim=0, power_iters=2)
    tl = tnn.SpectralNorm(shape, dim=0, power_iters=2, device="cpu")
    assert sorted(dict(tl.named_buffers())) == ["u", "v"]
    assert tl.u.shape == (6,) and tl.v.shape == (12,)
    load_numpy_state(tl, {k: np.asarray(v) for k, v in
                          jl.named_buffers().items()})
    w = f32(*shape)
    want, new_buf = jl.functional_call(
        {}, jnp.asarray(w), buffers=dict(jl.named_buffers()), training=True)
    tw = torch.from_numpy(w).requires_grad_(True)
    got = tl(tw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    for k in ("u", "v"):
        np.testing.assert_allclose(getattr(tl, k).numpy(),
                                   np.asarray(new_buf[k]), atol=1e-5,
                                   rtol=1e-5)
    tl.eval()
    before = tl.u.clone()
    tl(tw)
    assert torch.equal(tl.u, before)


def test_every_public_name_has_a_case():
    import inspect

    covered = {n for n in CASES}
    for mod in (J,):
        for name, f in vars(mod).items():
            if (inspect.isfunction(f) and not name.startswith("_")
                    and f.__module__ == mod.__name__):
                assert any(c.startswith(name) for c in covered), name
    for name in ("interpolate", "pixel_shuffle", "pad2d", "space_to_depth",
                 "shuffle_channel", "grid_sampler", "temporal_shift"):
        assert any(c.startswith(name) for c in covered), name
