"""The port's beam search with log-probs on the card: an empty state, or
a state kept on the host, decodes as the same search on the CPU does,
which tests/test_torch_decode_ops.py holds against the JAX package. The
file imports no JAX, so it runs where only the port is installed. Skips
without a card."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import decode as TD


def _stateless_beam(tables, **kw):
    """Beam search over per-step log-prob tables (on their device) with
    an empty state, the step counted on the host; returns (sequences,
    scores, the device type of each step's tokens)."""
    seen = []

    def step(state, tok):
        seen.append(tok.device.type)
        return tables[len(seen) - 1].expand(tok.shape[0], -1), state

    return (*TD.beam_search({}, step, **kw), seen)


@pytest.mark.gpu
def test_beam_search_follows_cuda_log_probs_of_a_host_state():
    """The beams follow the log-probs onto the card and each state leaf
    is gathered on its own device: sequences equal to the CPU's, scores
    within 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    v, k, t_len = 7, 3, 5
    rng = np.random.default_rng(5)
    tables = torch.from_numpy(np.log(rng.dirichlet(np.ones(v), size=t_len))
                              .astype(np.float32))
    kw = dict(beam_size=k, max_len=t_len, bos_id=0, end_id=6,
              length_penalty=0.6)
    want = _stateless_beam(tables, **kw)
    got = _stateless_beam(tables.cuda(), **kw)
    assert got[0].device.type == "cuda"
    assert got[2] == ["cpu"] + ["cuda"] * (t_len - 1)
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].numpy())
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].numpy(),
                               atol=1e-6, rtol=0)

    def host_state(state, tok):
        return tables.cuda()[state["t"].long()], {"t": state["t"] + 1}

    seqs, scores = TD.beam_search({"t": torch.zeros(k, dtype=torch.int32)},
                                  host_state, **kw)
    np.testing.assert_array_equal(seqs.cpu().numpy(), want[0].numpy())
    np.testing.assert_allclose(scores.cpu().numpy(), want[1].numpy(),
                               atol=1e-6, rtol=0)
