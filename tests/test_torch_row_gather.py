"""ops/row_gather.py on the CPU: gather_rows's forward is plain
indexing bit for bit, and its backward (the plain version here, and the
card's one-hot product run on the CPU) sums each lane's gradient into
its row as index_add_ does, in float64. Its card cases (bit-equal
across calls, against index_add_) are in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from julia_raytracer_tpu_torch.ops import row_gather as rgat

LANES = 4099  # not a multiple of any block


def _case(rows, seed=0, dtype=torch.float64):
    g = np.random.default_rng(seed)
    idx = torch.as_tensor(g.integers(0, rows, LANES))
    tables = [torch.as_tensor(g.normal(size=(rows,) + tail), dtype=dtype)
              for tail in ((3,), (), (3,))]
    grads = [torch.as_tensor(g.normal(size=(LANES,) + tuple(t.shape[1:])),
                             dtype=dtype) for t in tables]
    return idx, tables, grads


@pytest.mark.parametrize("rows", [1, 7, rgat.ONEHOT_ROWS + 5])
def test_gather_rows_grads_equal_index_add(rows):
    """Forward: table[idx]. Backward, float64: each table's gradient is
    index_add_ of its lane gradients; a table that takes no gradient gets
    none."""
    idx, tables, grads = _case(rows)
    leaves = [t.clone().requires_grad_(k != 1) for k, t in enumerate(tables)]
    outs = rgat.gather_rows(idx, *leaves)
    for out, t in zip(outs, tables, strict=True):
        assert torch.equal(out.detach(), t[idx])
    torch.autograd.backward([outs[0], outs[2]], [grads[0], grads[2]])
    assert leaves[1].grad is None
    for k in (0, 2):
        want = torch.zeros_like(tables[k]).index_add_(0, idx, grads[k])
        assert torch.equal(leaves[k].grad, want)


@pytest.mark.parametrize("rows", [1, 7, rgat.ONEHOT_ROWS + 5])
def test_onehot_sum_equals_index_add(rows):
    """The card's formulation (one-hot blocks of ONEHOT_ROWS rows,
    float64) computed on the CPU against index_add_ in float64, and in
    float32 within the float32 rounding of the sums."""
    idx, _, grads = _case(rows, seed=1)
    g = torch.cat([grads[0], grads[1][:, None]], dim=1)
    want = torch.zeros((rows, 4), dtype=torch.float64).index_add_(0, idx, g)
    got = rgat.rows_sum_onehot(idx, g, rows)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)
    got32 = rgat.rows_sum_onehot(idx, g.float(), rows)
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-4)
    assert torch.equal(rgat.rows_sum(idx, g, rows),
                       rgat.rows_sum_plain(idx, g, rows))


def test_gather_rows_without_grad_is_indexing():
    idx, tables, _ = _case(5)
    outs = rgat.gather_rows(idx, *tables)
    assert all(torch.equal(o, t[idx]) for o, t in zip(outs, tables))
    with pytest.raises(ValueError, match="row counts"):
        rgat.gather_rows(idx, tables[0].requires_grad_(), torch.zeros(3))
