"""The port's op library (counterpart of paddle_tpu/ops): the namespace
users call, with the JAX package's names and aliases for every module
of its ``ops`` (the detection suite and ``nn_extra`` included), plus
attention, the paged KV cache and the CUDA kernels under
``ops/kernels``. Every public name of ``paddle_tpu.ops`` has its
counterpart here (tests/test_torch_namespace.py)."""

from . import (control_flow, decode, detection, detection_extra, loss, math,
               nn, nn_extra, reduction, rnn, sampling, sequence, tensor)
from .control_flow import (TensorArray, case, cond, equal, fori_loop,
                           greater_equal, greater_than, less_equal,
                           less_than, logical_and, logical_not, logical_or,
                           logical_xor, not_equal, scan, static_rnn,
                           switch_case, while_loop)
from .decode import (beam_search, beam_search_batch_step,
                     beam_search_decode_lod, beam_search_step, crf_decoding,
                     ctc_align, ctc_greedy_decode, ctc_loss, edit_distance,
                     gather_beams, linear_chain_crf)
from .detection import (anchor_generator, bipartite_match, box_clip,
                        box_coder, collect_fpn_proposals, density_prior_box,
                        distribute_fpn_proposals, generate_proposals,
                        iou_similarity, matrix_nms, multiclass_nms, nms,
                        polygon_box_transform, prior_box, roi_align, roi_pool,
                        target_assign, yolo_box)
from .detection_extra import (box_decoder_and_assign,
                              generate_proposal_labels, mine_hard_examples,
                              psroi_pool, roi_perspective_transform,
                              rpn_target_assign, yolov3_loss)
from .loss import (bpr_loss, cross_entropy, hinge_loss, huber_loss,
                   kldiv_loss, label_smooth, log_loss, margin_rank_loss,
                   mse_loss, modified_huber_loss, npair_loss, rank_loss,
                   sigmoid_cross_entropy_with_logits, smooth_l1_loss,
                   softmax_with_cross_entropy, square_error_cost)
from .math import (abs, acos, asin, atan, bilinear_tensor_product, brelu,
                   ceil, clip, clip_by_norm, cos, cos_sim, cumsum,
                   elementwise_add, elementwise_div, elementwise_floordiv,
                   elementwise_max, elementwise_min, elementwise_mod,
                   elementwise_mul, elementwise_pow, elementwise_sub, elu,
                   exp, floor, gelu, hard_shrink, hard_sigmoid, increment,
                   isfinite, l1_norm, leaky_relu, log, logsigmoid, logsumexp,
                   matmul, maxout, mul, pow, prelu, reciprocal, relu, relu6,
                   round, rsqrt, scale, selu, sigmoid, sign, sin, soft_relu,
                   softplus, softshrink, softsign, sqrt, square,
                   squared_l2_distance, squared_l2_norm, stanh, swish, tanh,
                   tanh_shrink, thresholded_relu)
from .nn import (adaptive_pool2d, batch_norm, conv2d, conv2d_transpose,
                 conv3d, depthwise_conv2d, dropout, embedding, grid_sampler,
                 group_norm, interpolate, l2_normalize, layer_norm,
                 log_softmax, lrn, one_hot, pad2d, pixel_shuffle, pool2d,
                 rms_norm, shuffle_channel, softmax, space_to_depth,
                 temporal_shift)
from .nn_extra import (affine_channel, affine_grid, bilinear_interp,
                       conv3d_transpose, cvm, data_norm,
                       depthwise_conv2d_transpose, fsp_matrix,
                       max_pool2d_with_index, max_pool3d_with_index,
                       nearest_interp, pool3d, similarity_focus, spp,
                       tree_conv, unpool)
from .reduction import (mean, reduce_all, reduce_any, reduce_max,
                        reduce_mean, reduce_min, reduce_prod, reduce_sum)
from .rnn import (conv_shift, dynamic_rnn, gru, gru_unit, lstm, lstm_unit,
                  lstmp, row_conv, sequence_conv)
from .sampling import (hsigmoid_loss, nce_loss, sample_classes,
                       sample_from_logits, sample_logits, sampling_id,
                       top_k_logits, top_p_logits)
from .sequence import (add_position_encoding, chunk_eval, sequence_concat,
                       sequence_enumerate, sequence_expand, sequence_mask,
                       sequence_pad, sequence_pool, sequence_reshape,
                       sequence_reverse, sequence_scatter, sequence_slice,
                       sequence_softmax, sequence_unpad)
from .tensor import (arg_max, arg_min, argsort, assign, cast, concat, crop,
                     diag, expand, expand_as, eye, fill_constant,
                     fill_constant_batch_size_like, fill_zeros_like,
                     flatten, gather, gather_nd, gaussian_random, linspace,
                     multiplex, ones, pad, pad_constant_like, reshape,
                     reverse, scatter, scatter_nd_add, shape, slice, split,
                     squeeze, stack, top_k, transpose, tril, triu,
                     truncated_gaussian_random, uniform_random, unsqueeze,
                     unstack, where, zeros)

# --- the reference's op names whose capability lives under another name --
from .decode import ctc_loss as warpctc
from .loss import softmax_with_cross_entropy as cross_entropy2
from .math import elementwise_sub as minus
from .nn import embedding as lookup_table
from .nn import l2_normalize as norm
from .sequence import hash_embedding_ids as hash  # noqa: A001
from .tensor import arange as range  # noqa: A001 - the reference's name
from .tensor import fill_constant as fill
from .tensor import flatten as flatten2
from .tensor import reshape as reshape2
from .tensor import squeeze as squeeze2
from .tensor import transpose as transpose2
from .tensor import unsqueeze as unsqueeze2
