"""Every public callable the port shares with the JAX package accepts the
JAX package's arguments.

For each module of ``paddle_tpu_torch`` with a counterpart at the same
path under ``paddle_tpu``, each public function or class defined there
whose name the counterpart also has is compared by ``inspect.signature``:
a function as it is, a class by ``__init__`` and by each public method
that a class of the port defines (methods the port's layers inherit from
``torch.nn.Module`` are the intended ``nn.Module``-style difference and
are not compared). A test fails on a parameter of the JAX package's that
the port lacks, or on shared positional parameters in another order;
``INTENDED`` lists the differences that are kept, each with its reason.

Then one case per argument that this check made the port accept: its
ported effect (against the JAX package where it computes something), or
the typed ``UnimplementedError`` naming its ROADMAP item."""

import importlib
import inspect
import pkgutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch
from paddle_tpu_torch import initializer as I
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import InvalidArgumentError, UnimplementedError
from paddle_tpu_torch.ops import attention as TA
from paddle_tpu_torch.ops import paged_kv as TP
from paddle_tpu_torch.parallel import Trainer
from paddle_tpu_torch.quant import int8_linear
from paddle_tpu_torch.serving import PagedKVPool

# "module:qualname" -> {JAX parameter: the port's parameter in its place}.
# key -> generator: a torch.Generator stands for the JAX PRNG key (the two
# give different numbers from one seed, so sampled tokens compare in
# distribution only)
INTENDED = {
    "models.gpt:GPTForCausalLM.generate": {"key": "generator"},
    "models.speculative:speculative_generate": {"key": "generator"},
    "ops.nn:dropout": {"key": "generator"},
    "ops.sampling:sample_from_logits": {"key": "generator"},
    "serving:BatchedDecoder.__init__": {"key": "generator"},
}
_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
               inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _shared_callables():
    """(label, port callable, JAX callable) for every shared name."""
    out = []
    for info in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                      "paddle_tpu_torch."):
        mod = importlib.import_module(info.name)
        rest = info.name[len("paddle_tpu_torch."):]
        try:
            ref = importlib.import_module("paddle_tpu." + rest)
        except ModuleNotFoundError:
            continue         # a port-only module (ops.kernels, ...)
        for name, obj in sorted(vars(mod).items()):
            if name.startswith("_") or getattr(obj, "__module__", None) \
                    != info.name or not (inspect.isfunction(obj)
                                         or inspect.isclass(obj)):
                continue
            robj = getattr(ref, name, None)
            if robj is None:
                continue
            if inspect.isfunction(obj):
                out.append((f"{rest}:{name}", obj, robj))
                continue
            out.append((f"{rest}:{name}.__init__", obj.__init__,
                        robj.__init__))
            for meth in sorted(dir(obj)):
                owner = next((c for c in obj.__mro__ if meth in vars(c)),
                             None)
                if meth.startswith("_") or owner is None or not \
                        owner.__module__.startswith("paddle_tpu_torch."):
                    continue
                fn, rfn = getattr(obj, meth), getattr(robj, meth, None)
                if callable(fn) and callable(rfn):
                    out.append((f"{rest}:{name}.{meth}", fn, rfn))
    return out


SHARED = _shared_callables()


def test_the_comparison_sees_the_shared_surface():
    labels = {label for label, _, _ in SHARED}
    for want in ("slim.core:Compressor.__init__",
                 "slim.core:Context.from_file",
                 "slim.core:SensitivePruneStrategy.__init__",
                 "slim.prune:shrink_params", "slim.prune:Pruner.make_masks",
                 "slim.distill:Distiller.loss",
                 "quant.ops:fake_quantize_range_abs_max",
                 "core.places:set_device", "core.enforce:enforce_in",
                 "nn.layer:Layer.set_parameters",
                 "nn.layer:Layer.named_sublayers",
                 "nn.layer:Parameter.__init__",
                 "data.bucketing:bucket_by_length",
                 "nn.layers:Linear.__init__", "optimizer.optimizers:Adam."
                 "__init__", "ops.attention:xla_attention",
                 "parallel.api:Trainer.supervised", "serving:PagedKVPool."
                 "__init__", "nn.layers:MultiHeadAttention.attend_kv",
                 "checkpoint:save_state", "checkpoint:restore_state",
                 "checkpoint:CheckpointManager.__init__",
                 "checkpoint:CheckpointManager.restore",
                 "train_loop:TrainLoop.run", "train_loop:TrainLoop.__init__",
                 "data.device_loader:DevicePrefetcher.__init__",
                 "data.device_loader:BucketPadder.__init__",
                 "resilience.faults:FaultInjector.on",
                 "resilience.retry:retry_io",
                 "resilience.preemption:PreemptionHandler.__init__",
                 "resilience.integrity:verify_bytes",
                 "utils.atomic:atomic_write_bytes",
                 "core.config:FlagRegistry.define",
                 "parallel.api:Trainer.restore_checkpoint",
                 "parallel.api:Trainer.state",
                 "optimizer.optimizers:Lamb.__init__",
                 "optimizer.optimizers:ExponentialMovingAverage.update",
                 "serving:BatchedDecoder.warm_step",
                 "serving:BatchedDecoder.set_degraded",
                 "serving:BatchedDecoder.prefill_export",
                 "serving:BatchedDecoder.inject_prefilled",
                 "serving:KVHandoff.__init__", "serving:KVHandoff.from_bytes",
                 "serving:TokenStream.offer", "serving:TokenStream.put",
                 "serving:PagedKVPool.share",
                 "nn.layers:MultiHeadAttention.forward_chunk_rows",
                 "nn.layers:MultiHeadAttention.forward_chunk_paged_rows",
                 "ops.paged_kv:write_chunk_rows", "ops.paged_kv:import_pages",
                 "models.speculative:speculative_generate",
                 "nn.rewrite:rewrite_linears",
                 "quant.weight_only:WeightOnlyLinear.__init__",
                 "quant.weight_only:apply_weight_only_int8",
                 # the convolutional slice
                 "nn.layers:Conv2D.__init__",
                 "nn.layers:Conv2DTranspose.__init__",
                 "nn.layers:Pool2D.__init__", "nn.layers:BatchNorm.__init__",
                 "nn.layers:GroupNorm.__init__", "nn.layers:PRelu.__init__",
                 "nn.layers:Flatten.__init__", "nn.layers:GELU.__init__",
                 "nn.layers:Softmax.__init__", "ops.nn:conv2d",
                 "ops.nn:depthwise_conv2d", "ops.nn:conv2d_transpose",
                 "ops.nn:conv3d", "ops.nn:pool2d", "ops.nn:adaptive_pool2d",
                 "ops.nn:batch_norm", "ops.nn:group_norm",
                 "ops.nn:l2_normalize", "ops.nn:lrn", "ops.nn:softmax",
                 "ops.nn:log_softmax", "ops.nn:one_hot", "ops.math:prelu",
                 "ops.tensor:flatten", "initializer:Uniform.__init__",
                 "initializer:Normal.__init__",
                 "initializer:TruncatedNormal.__init__",
                 "initializer:MSRA.__init__",
                 "initializer:NumpyArray.__init__",
                 "models.mnist:MnistCNN.__init__", "models.mnist:loss_fn",
                 "models.mnist:eval_metrics", "models.resnet:ResNet.__init__",
                 "models.resnet:BottleneckBlock.__init__",
                 "models.resnet:BasicBlock.__init__",
                 "models.resnet:resnet50", "models.resnet:resnet20_cifar",
                 "models.resnet:loss_fn", "quant.int8:int8_conv2d",
                 "quant.int8:Int8Conv2D.__init__",
                 "parallel.api:Trainer.train_steps",
                 # the NMT and ViT slice
                 "nn.transformer:TransformerDecoderLayer.__init__",
                 "nn.transformer:TransformerDecoder.forward",
                 "nn.transformer:PositionalEncoding.__init__",
                 "nn.transformer:LearnedPositionalEmbedding.__init__",
                 "nn.transformer:decoder_layer_step", "ops.loss:label_smooth",
                 "ops.decode:ctc_loss", "ops.decode:ctc_align",
                 "ops.decode:ctc_greedy_decode",
                 "ops.decode:beam_search_step", "ops.decode:beam_search",
                 "ops.decode:beam_search_decode",
                 "ops.decode:beam_search_batch_step",
                 "ops.decode:beam_search_decode_lod",
                 "ops.decode:gather_beams", "ops.decode:linear_chain_crf",
                 "ops.decode:crf_decoding", "ops.decode:edit_distance",
                 "models.transformer:TransformerNMT.__init__",
                 "models.transformer:TransformerNMT.forward_fused_loss",
                 "models.transformer:TransformerNMT.greedy_decode_cached",
                 "models.transformer:TransformerNMT.beam_decode_cached",
                 "models.transformer:nmt_loss",
                 "models.transformer:nmt_metrics",
                 "models.vit:ViT.__init__", "models.vit:ViT.forward",
                 "models.vit:loss_fn",
                 # the MoE, CNN-zoo and recurrent slice
                 "nn.moe:switch_moe", "nn.moe:SwitchFFN.__init__",
                 "nn.moe:SwitchFFN.capacity", "nn.moe:SwitchFFN.forward",
                 "nn.rnn_layers:LSTM.__init__", "nn.rnn_layers:GRU.forward",
                 "nn.layers:GRUCell.__init__", "nn.layers:LSTMCell.forward",
                 "nn.layers:RNN.__init__", "nn.layers:RNN.forward",
                 "ops.rnn:lstm_unit", "ops.rnn:gru_unit", "ops.rnn:lstm",
                 "ops.rnn:gru", "ops.rnn:lstmp", "ops.rnn:row_conv",
                 "ops.rnn:conv_shift", "ops.rnn:sequence_conv",
                 "ops.rnn:dynamic_rnn", "ops.sequence:sequence_mask",
                 "models.vgg:VGG.__init__", "models.vgg:vgg16",
                 "models.vgg:loss_fn", "models.alexnet:AlexNet.__init__",
                 "models.alexnet:alexnet", "models.alexnet:loss_fn",
                 "models.googlenet:GoogLeNet.__init__",
                 "models.googlenet:Inception.__init__",
                 "models.googlenet:AuxHead.__init__",
                 "models.googlenet:googlenet", "models.googlenet:loss_fn",
                 "models.se_resnext:SEResNeXt.__init__",
                 "models.se_resnext:SEBottleneck.__init__",
                 "models.se_resnext:SEBlock.__init__",
                 "models.se_resnext:se_resnext50",
                 "models.se_resnext:loss_fn",
                 "models.stacked_lstm:StackedLSTM.__init__",
                 "models.stacked_lstm:StackedLSTM.forward",
                 "models.stacked_lstm:loss_fn",
                 # the detection slice and the rest of the ops
                 "ops.detection:iou_similarity", "ops.detection:box_coder",
                 "ops.detection:box_clip",
                 "ops.detection:polygon_box_transform",
                 "ops.detection:expand_aspect_ratios",
                 "ops.detection:prior_box_count", "ops.detection:prior_box",
                 "ops.detection:density_prior_box",
                 "ops.detection:anchor_generator", "ops.detection:yolo_box",
                 "ops.detection:nms", "ops.detection:multiclass_nms",
                 "ops.detection:matrix_nms", "ops.detection:roi_align",
                 "ops.detection:roi_pool", "ops.detection:generate_proposals",
                 "ops.detection:bipartite_match",
                 "ops.detection:target_assign",
                 "ops.detection:distribute_fpn_proposals",
                 "ops.detection:collect_fpn_proposals",
                 "ops.detection:ssd_match", "ops.detection:ssd_loss",
                 "ops.detection:detection_output",
                 "ops.detection_extra:psroi_pool",
                 "ops.detection_extra:roi_perspective_transform",
                 "ops.detection_extra:rpn_target_assign",
                 "ops.detection_extra:mine_hard_examples",
                 "ops.detection_extra:box_decoder_and_assign",
                 "ops.detection_extra:generate_proposal_labels",
                 "ops.detection_extra:yolov3_loss",
                 "ops.detection_extra:poly2mask",
                 "ops.detection_extra:polys_to_mask_wrt_box",
                 "ops.detection_extra:generate_mask_labels",
                 "ops.nn:interpolate", "ops.nn:pixel_shuffle", "ops.nn:pad2d",
                 "ops.nn:space_to_depth", "ops.nn:shuffle_channel",
                 "ops.nn:grid_sampler", "ops.nn:temporal_shift",
                 "ops.nn_extra:pool3d", "ops.nn_extra:max_pool2d_with_index",
                 "ops.nn_extra:max_pool3d_with_index", "ops.nn_extra:unpool",
                 "ops.nn_extra:spp", "ops.nn_extra:affine_channel",
                 "ops.nn_extra:affine_grid", "ops.nn_extra:conv3d_transpose",
                 "ops.nn_extra:depthwise_conv2d_transpose",
                 "ops.nn_extra:data_norm", "ops.nn_extra:bilinear_interp",
                 "ops.nn_extra:nearest_interp", "ops.nn_extra:fsp_matrix",
                 "ops.nn_extra:similarity_focus", "ops.nn_extra:cvm",
                 "ops.nn_extra:tree_conv", "ops.nn_extra:adaptive_pool3d",
                 "ops.nn_extra:spectral_norm",
                 "ops.nn_extra:image_resize_short",
                 "nn.layers:MultiBoxHead.__init__",
                 "nn.layers:MultiBoxHead.forward",
                 "nn.layers:SpectralNorm.__init__",
                 "nn.layers:SpectralNorm.forward", "metrics:detection_map",
                 "metrics:DetectionMAP.__init__",
                 "metrics:DetectionMAP.update",
                 "models.stacked_lstm:eval_metrics",
                 "parallel.api:Trainer.supervised",
                 # the recommender, LoRA and op-library slice
                 "models.recommender:RecommenderNet.__init__",
                 "models.recommender:RecommenderNet.forward",
                 "models.recommender:loss_fn",
                 "nn.lora:LoRALinear.__init__", "nn.lora:LoRALinear.forward",
                 "nn.lora:LoRALinear.merged_weight",
                 "nn.lora:LoRALinear.to_linear", "nn.lora:apply_lora",
                 "nn.lora:lora_parameters", "nn.lora:merge_lora",
                 "nn.sampling_layers:NCE.__init__",
                 "nn.sampling_layers:NCE.forward",
                 "nn.sampling_layers:HSigmoid.__init__",
                 "nn.sampling_layers:HSigmoid.forward",
                 "nn.layers:BilinearTensorProduct.__init__",
                 "nn.layers:BilinearTensorProduct.forward",
                 "ops.tensor:gather", "ops.tensor:gather_nd",
                 "ops.tensor:scatter", "ops.tensor:scatter_nd_add",
                 "ops.tensor:top_k", "ops.tensor:argsort",
                 "ops.tensor:uniform_random", "ops.tensor:random_crop",
                 "ops.tensor:unique_with_counts", "ops.tensor:where_index",
                 "ops.tensor:fill_constant", "ops.tensor:strided_slice",
                 "ops.math:matmul", "ops.math:mul", "ops.math:cos_sim",
                 "ops.math:elementwise_floordiv", "ops.math:maxout",
                 "ops.math:bilinear_tensor_product", "ops.math:logsumexp",
                 "ops.reduction:reduce_prod", "ops.reduction:sum",
                 "ops.loss:cross_entropy", "ops.loss:bpr_loss",
                 "ops.loss:npair_loss",
                 "ops.loss:sampled_softmax_with_cross_entropy",
                 "ops.loss:teacher_student_sigmoid_loss",
                 "ops.sampling:nce_loss", "ops.sampling:hsigmoid_loss",
                 "ops.sampling:sample_classes", "ops.sampling:sample_logits",
                 "ops.sampling:sampling_id", "ops.sequence:sequence_pad",
                 "ops.sequence:sequence_expand", "ops.sequence:chunk_eval",
                 "ops.sequence:hash_embedding_ids",
                 "ops.sequence:sequence_scatter",
                 "ops.sequence:sequence_concat",
                 "ops.control_flow:while_loop", "ops.control_flow:scan",
                 "ops.control_flow:static_rnn", "ops.control_flow:case",
                 "ops.control_flow:switch_case",
                 "ops.control_flow:TensorArray.__init__",
                 "ops.control_flow:TensorArray.write",
                 "metrics:Accuracy.update", "metrics:EditDistance.update",
                 "metrics:CompositeMetric.__init__", "metrics:chunk_eval",
                 "metrics:ChunkEvaluator.update", "metrics:mean_iou",
                 "metrics:precision_recall",
                 "metrics:positive_negative_pair"):
        assert want in labels
    assert set(INTENDED) <= labels


@pytest.mark.parametrize("label,port,ref", SHARED,
                         ids=[label for label, _, _ in SHARED])
def test_port_takes_every_reference_argument(label, port, ref):
    ps, rs = inspect.signature(port), inspect.signature(ref)
    intended = INTENDED.get(label, {})
    assert all(n in ps.parameters for n in intended.values()), label
    missing = [n for n, p in rs.parameters.items()
               if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
               and n not in ps.parameters and n not in intended]
    assert not missing, f"{label}: the port lacks {missing}"
    pos = [n for n, p in ps.parameters.items() if p.kind in _POSITIONAL
           and n not in intended.values()]
    rpos = [n for n, p in rs.parameters.items() if p.kind in _POSITIONAL
            and n not in intended]
    n = min(len(pos), len(rpos))
    assert pos[:n] == rpos[:n], f"{label}: positional {pos} != {rpos}"


# ----- what each newly accepted argument does ------------------------------

def test_adam_lazy_mode_steps_like_the_dense_rule():
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(4, 3)).astype(np.float32)
    grads = [rng.normal(size=(4, 3)).astype(np.float32) for _ in range(3)]
    out = []
    for lazy in (False, True):
        p = {"w": torch.from_numpy(p0.copy())}
        opt = topt.Adam(1e-2, lazy_mode=lazy)
        state = opt.init(p)
        for g in grads:
            opt.apply(p, {"w": torch.from_numpy(g)}, state)
        out.append(p["w"])
    assert torch.equal(out[0], out[1])


def test_gather_rows_full_keeps_the_whole_view():
    from paddle_tpu.ops import paged_kv as JP

    rng = np.random.default_rng(1)
    pool = rng.normal(size=(6, 64, 2, 8)).astype(np.float32)
    table = np.array([[4, 1, 3], [0, 5, 2]], np.int32)
    short = TP.gather_rows(torch.from_numpy(pool), torch.from_numpy(table),
                           upto=64)
    full = TP.gather_rows(torch.from_numpy(pool), torch.from_numpy(table),
                          upto=64, full=True)
    assert short.shape[1] == 64 and full.shape[1] == 3 * 64
    want = JP.gather_rows(jnp.asarray(pool), jnp.asarray(table), upto=64,
                          full=True)
    np.testing.assert_array_equal(full.numpy(), np.asarray(want))


def test_linear_and_embedding_initializers():
    from paddle_tpu import initializer as JI

    tl = tnn.Linear(5, 3, weight_init=I.Constant(0.5),
                    bias_init=I.Constant(0.25), device="cpu")
    jl = pt.nn.Linear(5, 3, weight_init=JI.Constant(0.5),
                      bias_init=JI.Constant(0.25))
    x = np.random.default_rng(2).normal(size=(2, 5)).astype(np.float32)
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jl(jnp.asarray(x))), atol=1e-6)
    te = tnn.Embedding(7, 4, weight_init=I.Constant(-1.5), device="cpu")
    assert torch.all(te.weight == -1.5)


def test_dropout_mode_downgrade_in_infer():
    x = np.random.default_rng(3).normal(size=(3, 4)).astype(np.float32)
    for mode in ("upscale_in_train", "downgrade_in_infer"):
        td = tnn.Dropout(0.3, mode=mode).eval()
        jd = pt.nn.Dropout(0.3, mode=mode)
        jd.eval()
        np.testing.assert_allclose(td(torch.from_numpy(x)).numpy(),
                                   np.asarray(jd(jnp.asarray(x))),
                                   atol=1e-7)


def test_paged_pool_arrays_and_layer_list_layers():
    al = PagedKVPool(4, 64, 2, 8, device="cpu")
    assert al.kpool.shape == al.vpool.shape == (4, 64, 2, 8)
    assert not al.kpool.any()
    al = PagedKVPool(4, 64, 2, 8, arrays=False, device="cpu")
    assert al.kpool is None and al.vpool is None
    layers = tnn.LayerList(layers=[tnn.Linear(2, 2, device="cpu")
                                   for _ in range(2)])
    assert [n for n, _ in layers.named_children()] == ["0", "1"]
    assert isinstance(tnn.Layer(name_scope="block"), torch.nn.Module)


def test_flash_shape_ok_takes_causal_and_window():
    for shape in ((128, 128, 64), (128, 96, 64), (64, 64, 32)):
        want = TA.flash_shape_ok(*shape)
        assert TA.flash_shape_ok(*shape, causal=True, window=32) == want


def test_attend_kv_masks_by_decode_t_or_attn_mask():
    """The reference's attend_kv call shape: with ``decode_t`` the decode
    wrapper masks by the cursors, with ``attn_mask`` the plain path does;
    both give the same attention."""
    torch.manual_seed(0)
    mha = tnn.MultiHeadAttention(32, 4, num_kv_heads=2, rotary=True,
                                 device="cpu").eval()
    k, v = torch.randn(2, 16, 2, 8), torch.randn(2, 16, 2, 8)
    x = torch.randn(2, 1, 32)
    t = torch.tensor([5, 11], dtype=torch.int32)
    pos = t[:, None]
    by_cursor = mha.attend_kv(x, k, v, q_positions=pos, decode_t=t)
    by_mask = mha.attend_kv(x, k, v, attn_mask=TA.cache_keep_mask(pos, 16),
                            q_positions=pos)
    torch.testing.assert_close(by_cursor, by_mask, atol=1e-6, rtol=0)


def _raises(item, fn, *args, **kw):
    with pytest.raises(UnimplementedError, match=item):
        fn(*args, **kw)


def test_unported_arguments_raise_naming_their_item():
    q = torch.zeros((1, 64, 2, 64))
    cpu = dict(device="cpu")
    # seq_parallel and mesh= are ported (tests/test_torch_seq_parallel.py
    # holds them against the JAX package); a mesh= that is no mesh raises
    assert tnn.MultiHeadAttention(32, 4, seq_parallel="ring",
                                  **cpu).seq_parallel == "ring"
    model = tnn.Linear(2, 2, device="cpu")
    opt = topt.Adam(1e-3)
    with pytest.raises(InvalidArgumentError, match="takes a mesh"):
        Trainer.supervised(model, opt, lambda o, y: o.sum(), mesh=object())
    # the MoE loss terms are ported (tests/test_torch_moe.py holds them
    # against the JAX Trainer): a training step adds weight x the Switch
    # FFN's recorded term, eval_step reports the task loss
    moe = tnn.SwitchFFN(4, 8, 2, device="cpu")
    x = torch.randn(2, 3, 4, generator=torch.Generator().manual_seed(0))
    for name in ("aux_loss", "router_z_loss"):
        weight = {"aux_loss": "aux_loss_weight",
                  "router_z_loss": "router_z_loss_weight"}[name]
        tr = Trainer.supervised(moe, topt.SGD(0.0), lambda o, y: o.sum(),
                                **{weight: 0.5})
        loss, _ = tr.train_step((x, None))
        task, _ = tr.eval_step((x, None))
        term = getattr(moe, name)
        assert float(term) > 0 and not term.requires_grad
        torch.testing.assert_close(loss, task + 0.5 * term, atol=1e-5,
                                   rtol=0)
    # the tile and dispatch arguments are ported (queue 2 item 3): they
    # run, and a tile outside a kernel's menu raises naming the menu
    # (tests/test_torch_tuning.py holds them against the JAX package)
    entry = {"weight_int8": torch.ones((4, 2), dtype=torch.int8),
             "weight_scale": torch.ones(2), "act_scale": torch.tensor(1.0)}
    x4 = torch.ones(3, 4)
    for kw in (dict(use_pallas=True), dict(use_pallas=False),
               dict(interpret=True)):
        assert torch.equal(int8_linear(x4, entry, **kw),
                           int8_linear(x4, entry))
    with pytest.raises(InvalidArgumentError, match=r"menu \(128, 64\)"):
        TA.flash_attention(q, q, q, block_q=32)
    # at their defaults they change nothing
    assert Trainer.supervised(model, opt, lambda o, y: o.sum(), mesh=None,
                              aux_loss_weight=0.0,
                              router_z_loss_weight=0.0) is not None
    torch.testing.assert_close(
        TA.xla_attention(q, q, q, dropout_p=0.0, dropout_key=None,
                         segment_ids=None), TA.xla_attention(q, q, q))


def test_sparse_embedding_builds_and_trains():
    """``Embedding(is_sparse=True)``: a plain layer outside a sparse step,
    and inside ``sparse_minimize_fn``'s step its table moves on the
    touched rows only."""
    model = tnn.Embedding(16, 4, is_sparse=True, device="cpu")
    ids = torch.tensor([[1, 3], [3, 5]])
    torch.testing.assert_close(model(ids), model.weight[ids])
    before = model.weight.detach().clone()
    params = dict(model.named_parameters())
    init_fn, step_fn = topt.sparse_minimize_fn(
        model, lambda p, i: model.functional_call(p, i)[0].square().sum(),
        topt.SGD(0.1))
    state = init_fn(params)
    losses = [float(step_fn(params, state, ids)[0]) for _ in range(3)]
    assert losses[-1] < losses[0]
    moved = (model.weight.detach() != before).any(dim=1)
    assert moved.tolist() == [i in (1, 3, 5) for i in range(16)]


def test_trainer_build_strategy_steps_and_is_stored():
    """``Trainer(build_strategy=)`` keeps the strategy as ``strategy``
    (a default one when None) and steps as without it."""
    from paddle_tpu_torch.core.config import BuildStrategy

    strategy = BuildStrategy(donate_inputs=False, remat_policy="dots")
    model = tnn.Linear(2, 1, device="cpu")
    batch = {"x": torch.ones(4, 2), "label": torch.zeros(4, 1)}
    tr = Trainer.supervised(model, topt.SGD(0.1),
                            lambda o, y: (o - y).square().mean(),
                            build_strategy=strategy)
    assert tr.strategy is strategy
    losses = [float(tr.train_step(batch)[0]) for _ in range(3)]
    assert losses[-1] < losses[0]
    assert Trainer(model, topt.SGD(0.1), lambda *a: None).strategy == \
        BuildStrategy()


def test_checkpoint_slice_arguments_raise_naming_their_item(tmp_path):
    """The checkpoint-and-loop slice's arguments that come with later
    items: at any value but the default they raise naming the item; at
    the default they change nothing."""
    from paddle_tpu_torch import checkpoint as C
    from paddle_tpu_torch.data.device_loader import DevicePrefetcher
    from paddle_tpu_torch.train_loop import TrainLoop

    from paddle_tpu_torch.core.mesh import get_mesh
    from paddle_tpu_torch.resilience import FleetController

    d = str(tmp_path / "c")
    # the multi-process arguments (ported: tests/test_torch_multihost_
    # ckpt.py); in one process each takes effect as the JAX one's does
    for per_host in (True, None, False):
        C.save_state(d, {"x": torch.zeros(1)}, per_host=per_host)
    assert C.restore_state(d, mesh=get_mesh())["x"].shape == (1,)
    assert C.restore_state(d, shardings={})["x"].shape == (1,)
    assert C.restore_state(d, mesh=None, shardings=None)["x"].shape == (1,)
    assert C.load(d, mesh=get_mesh())["x"].shape == (1,)
    one = FleetController(rank=0, world=1)
    assert C.CheckpointManager(str(tmp_path / "m"),
                               coordinator=one).coordinator is one
    # DevicePrefetcher's mesh keywords are ported: each stages this
    # rank's rows of a batch (the one-rank mesh's: all of them)
    from paddle_tpu_torch.core.mesh import get_mesh, sharding
    from paddle_tpu_torch.core.sharding_types import PartitionSpec

    one = get_mesh()
    batch = [{"x": np.arange(8.0).reshape(4, 2)}]
    for kw in (dict(mesh=one), dict(sharding=sharding(
            PartitionSpec("dp"), one)), dict(mesh=one,
                                            stage_per_shard=True)):
        pref = DevicePrefetcher(batch, device="cpu", **kw)
        assert pref.stage_per_shard is True
        assert tuple(pref.sharding.spec) == ("dp",)
        got = list(pref)
        assert torch.equal(got[0]["x"], torch.from_numpy(batch[0]["x"]))
    with pytest.raises(Exception, match="stage_per_shard needs"):
        DevicePrefetcher([], device="cpu", stage_per_shard=True)
    model = tnn.Linear(2, 2, device="cpu")
    trainer = Trainer(model, topt.SGD(0.1), lambda *a: None)
    loop = TrainLoop(trainer, str(tmp_path / "loop"))
    _raises("queue 1 item 8", loop.run, [], debug_port=0)
    _raises("queue 1 item 8", loop.run, [], flight_recorder=object())
    _raises("queue 1 item 12", topt.Momentum().apply_gradients, [])
    assert loop.run([], debug_port=None, flight_recorder=None,
                    controller=None, preemption=None) == 0
    assert loop.run([], controller=FleetController(rank=0, world=1)) == 0


def test_convolution_slice_arguments():
    """The convolutional slice's keyword arguments: ``int8_conv2d``'s
    kernel choices run the same product; a Conv2D's ``weight_init``
    and ``dtype`` and ``one_hot``'s ``dtype`` take effect."""
    from paddle_tpu_torch.ops import nn as TN
    from paddle_tpu_torch.quant import int8_conv2d

    entry = {"weight_int8": torch.ones((2, 3, 1, 1), dtype=torch.int8),
             "weight_scale": torch.ones(2), "act_scale": torch.tensor(1.0)}
    x = torch.ones(1, 3, 2, 2)
    for kw in (dict(use_pallas=False), dict(interpret=True)):
        assert torch.equal(int8_conv2d(x, entry, **kw),
                           int8_conv2d(x, entry))
    assert int8_conv2d(x, entry, use_pallas=None,
                       interpret=False).shape == (1, 2, 2, 2)
    conv = tnn.Conv2D(3, 2, 1, weight_init=I.Constant(0.5), dtype="float32",
                      device="cpu")
    assert torch.all(conv.weight == 0.5)
    assert torch.equal(conv(x), torch.full((1, 2, 2, 2), 1.5))
    assert TN.one_hot(torch.tensor([1]), 3, dtype="int32").dtype == \
        torch.int32
