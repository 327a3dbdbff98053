"""Helpers of the op-library parity tests (tests/test_torch_ops_*.py):
one call of a JAX function and of its port on the same numpy inputs,
outputs compared leaf by leaf (a tree of tuples, lists and dicts), and
optionally the gradients of a fixed random projection of the float
outputs with respect to chosen inputs. The JAX side is jitted, the
non-array arguments held static."""

import jax
import jax.numpy as jnp
import numpy as np
import torch


def _is_array(a):
    return isinstance(a, np.ndarray)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def host(x):
    """A leaf as a numpy array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def compare(got, want, atol, rtol, what=""):
    """Every leaf of ``got`` (the port's) against ``want`` (JAX's): the
    same shape; integer and bool leaves equal, float leaves within
    ``atol + rtol * |want|`` (NaN where JAX has NaN)."""
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), (what, len(g), len(w))
    for i, (a, b) in enumerate(zip(g, w)):
        a, b = host(a), host(b)
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a.astype(np.float64),
                                       b.astype(np.float64), atol=atol,
                                       rtol=rtol, equal_nan=True,
                                       err_msg=f"{what} leaf {i}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} leaf {i}")


def run_pair(jfn, tfn, args, grad=(), seed=99):
    """(port outputs, JAX outputs, port grads, JAX grads): ``args`` are
    numpy arrays (traced) and other values (static); ``grad`` lists the
    positions of float arrays to differentiate by, through
    sum(out * c) over the float outputs with c drawn from numpy
    ``seed``."""
    pos = [i for i, a in enumerate(args) if _is_array(a)]

    def rebuild(arrs, conv):
        out = list(args)
        for i, a in zip(pos, arrs):
            out[i] = conv(a)
        return out

    def jcall(*arrs):
        return jfn(*rebuild(arrs, lambda a: a))

    jarrs = [jnp.asarray(args[i]) for i in pos]
    jout = jax.jit(jcall)(*jarrs)
    tin = rebuild([torch.from_numpy(np.array(args[i])) for i in pos],
                  lambda a: a)
    for i in grad:
        tin[i].requires_grad_(True)
    tout = tfn(*tin)
    if not grad:
        return tout, jout, None, None
    rng = np.random.default_rng(seed)
    cots = [rng.normal(size=np.shape(host(o))).astype(np.float32)
            for o in _leaves(jout)
            if np.issubdtype(host(o).dtype, np.floating)]

    def jloss(*arrs):
        outs = [o for o in _leaves(jcall(*arrs))
                if jnp.issubdtype(o.dtype, jnp.floating)]
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots))

    argnums = tuple(pos.index(i) for i in grad)
    jg = jax.jit(jax.grad(jloss, argnums=argnums))(*jarrs)
    touts = [o for o in _leaves(tout) if o.is_floating_point()]
    loss = sum(torch.sum(o * torch.from_numpy(c).to(o.dtype))
               for o, c in zip(touts, cots))
    loss.backward()
    return tout, jout, [tin[i].grad for i in grad], list(jg)


def check_pair(jfn, tfn, args, atol=1e-6, rtol=1e-6, grad=(), gatol=None):
    """:func:`run_pair`, then :func:`compare` on the outputs and on the
    grads (within ``gatol``, default ``atol``, plus ``rtol``)."""
    tout, jout, tg, jg = run_pair(jfn, tfn, args, grad)
    compare(tout, jout, atol, rtol, "outputs")
    if grad:
        compare(tg, jg, atol if gatol is None else gatol, rtol, "grads")
