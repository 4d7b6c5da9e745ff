"""FLOP counts of fully connected stacks from their shapes: 2·rows·in·out per
GEMM. A backward pass computes each layer's weight gradient and, where the
layer's input needs one, its input gradient; the first layer of a stack fed
by data needs none."""


def pairs(dims):
    return list(zip(dims[:-1], dims[1:]))


def forward(dims, rows: int) -> int:
    return sum(2 * rows * i * o for i, o in pairs(dims))


def backward(dims, rows: int, weights: bool = True, input_grad: bool = False) -> int:
    """Weight gradients (``weights``) and input gradients of every layer but
    the first, and of the first too with ``input_grad``."""
    layers = pairs(dims)
    w = forward(dims, rows) if weights else 0
    x = sum(2 * rows * i * o for n, (i, o) in enumerate(layers) if n > 0 or input_grad)
    return w + x
