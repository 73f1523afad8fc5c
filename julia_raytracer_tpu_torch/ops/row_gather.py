"""Row gathers of small tables by many lanes (the material tables of
ops/eval.py eval_material), with a backward that does not serialise.

The backward of `table[idx]` adds each lane's gradient into its row.
ATen's, on the card, sorts the lanes by row and walks each row's
duplicates in series: at 262,144 lanes onto a few material rows it is
one long chain a row (640-643 of a 651-662 device ms train-step backward
on an H100, PERF.md section 5), and float `index_add_` there adds with
atomics, in no fixed order. `gather_rows` gathers several tables of M
rows by the same ids; its backward sums each table's lane gradients into
its rows:
  - on the card: the one-hot product onehot(idx, M)^T @ grad, in float64
    (products of 0 and 1 are exact; cuBLAS adds in a fixed order, so two
    calls give the same bits, and TF32 settings do not apply), in blocks
    of ONEHOT_ROWS rows;
  - on the CPU: its plain version, `index_add_` (a serial sum in lane
    order).
The forward is `table[idx]`, bit for bit."""

from __future__ import annotations

import torch

# material rows of one one-hot block: [lanes, ONEHOT_ROWS] float64 (128
# MB at 262,144 lanes)
ONEHOT_ROWS = 64


def rows_sum_plain(idx, grad, rows: int):
    """Sum of the lane gradients grad [N, K] into `rows` rows by idx [N]:
    index_add_, the plain version."""
    return torch.zeros((rows, grad.shape[1]), dtype=grad.dtype,
                       device=grad.device).index_add_(0, idx, grad)


def rows_sum_onehot(idx, grad, rows: int):
    """rows_sum_plain as a one-hot product in float64, blocks of
    ONEHOT_ROWS rows (any device; the card's formulation)."""
    g64 = grad.to(torch.float64)
    ids = idx.to(torch.int64)[:, None]
    blocks = []
    for lo in range(0, rows, ONEHOT_ROWS):
        cols = torch.arange(lo, min(lo + ONEHOT_ROWS, rows), device=idx.device)
        blocks.append((ids == cols).to(torch.float64).T @ g64)
    return torch.cat(blocks).to(grad.dtype)


def rows_sum(idx, grad, rows: int):
    """The backward's reduction: the plain version for CPU tensors, the
    one-hot product on the card."""
    if grad.device.type == "cpu":
        return rows_sum_plain(idx, grad, rows)
    return rows_sum_onehot(idx, grad, rows)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, idx, *tables):
        ctx.save_for_backward(idx)
        ctx.shapes = [t.shape for t in tables]
        return tuple(t[idx] for t in tables)

    @staticmethod
    def backward(ctx, *grads):
        (idx,) = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        cols = [g.reshape(idx.shape[0], -1)
                for g, want in zip(grads, need) if want]
        summed = rows_sum(idx, torch.cat(cols, dim=1), ctx.shapes[0][0])
        out, col = [], 0
        for shape, want in zip(ctx.shapes, need):
            if not want:
                out.append(None)
                continue
            width = shape[1:].numel()
            out.append(summed[:, col:col + width].reshape(shape))
            col += width
        return (None, *out)


def gather_rows(idx, *tables):
    """(table[idx] for each table): tables of the same row count, each
    [M, ...] float, idx [N] integer. Without a gradient to carry, plain
    indexing."""
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in tables)):
        return tuple(t[idx] for t in tables)
    if len({t.shape[0] for t in tables}) != 1:
        raise ValueError("gather_rows: tables of different row counts "
                         f"{[tuple(t.shape) for t in tables]}")
    return _GatherRows.apply(idx, *tables)
