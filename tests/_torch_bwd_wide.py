"""The grouped FFN backward's f32 spread at moonshot's width, shared by the
CPU test that measures the reference (``test_torch_grouped_bwd.py``) and
the card test that holds the f32 CUDA entry (``test_torch_cuda.py``).

At D = 2048 the weight gradients sum 2048-deep recomputed products over up
to 200 rows; f32 rounding in any summation order moves them by a few 1e-4
against values of ~400, past the kernels' atol of 1e-4, in the reference
too.  So the f32 entry is held against an f64 evaluation of the same chain
on the same inputs, each output's largest gap within ``RATIO`` x the
reference's own (``REF_F64_GAP``, measured on the CPU from ``jax.vjp`` of
the reference's ``_grouped_ffn`` in f32) and ``RATIO`` x the plain
version's in f32 (``test_torch_cuda.wide_f32_spread``).  Imports no jax
(the card's machine has none).
"""
import numpy as np

# moonshot's widths at 448 rows: (m, d, f, gs), each with the weights of
# every slot (Gw 6) and with the last slot a pad slot without weights (5)
M, D, F, GS = 448, 2048, 1408, [100, 0, 37, 200, 65, 30]
N_W = (6, 5)
OUTPUTS = ("dxs", "dw_gate", "dw_up", "dw_down")
RATIO = 2.0
# max |reference f32 - f64| of each output on :func:`inputs` (measured and
# asserted within 2 % by test_torch_grouped_bwd.py's spread test)
REF_F64_GAP = {
    6: {"dxs": 2.5415e-05, "dw_gate": 2.0015e-04, "dw_up": 2.6985e-04,
        "dw_down": 1.6022e-04},
    5: {"dxs": 2.4586e-05, "dw_gate": 1.9015e-04, "dw_up": 1.8435e-04,
        "dw_down": 1.6472e-04},
}


def inputs(n_w):
    """Seeded numpy inputs: x [M, D], counts, w_gate/w_up [n_w, D, F],
    w_down [n_w, F, D], dy [M, D]; rows past the weighted slots' are 0."""
    rng = np.random.default_rng(M + D + n_w)
    x = rng.normal(0, 1, (M, D)).astype(np.float32)
    w = [(rng.normal(0, 1, (n_w, r, c)) * 0.3 * min(1.0, (64 / r) ** 0.5))
         .astype(np.float32) for r, c in ((D, F), (D, F), (F, D))]
    dy = rng.normal(0, 1, (M, D)).astype(np.float32)
    x[sum(GS[:n_w]):] = 0
    dy[sum(GS[:n_w]):] = 0
    return x, np.asarray(GS, np.int32), w, dy


def gaps(got, yardstick):
    """max |got - yardstick| of each output (numpy or tensors)."""
    return {n: float(np.abs(np.asarray(g, np.float64)
                            - np.asarray(y, np.float64)).max())
            for n, g, y in zip(OUTPUTS, got, yardstick)}
