"""Operations, bytes and FLOPs counted from shapes, and the card's peaks.

The peaks and the sigmoid and fused-step counts are a frozen copy of the
bring-up proof's arithmetic (``chip_smoke.py``: ``PEAK_F32_FLOPS``,
``_side_cost``, ``sigmoid_pair_cost``, ``sigmoid_bound``,
``fused_step_cost``). They count the cheapest correct evaluation of the
work from its shapes, never a kernel's own loop, so a later kernel that
does the same work is held to the same bound. The model FLOPs of a
training step (``*_model_flops``) are added here for ``mfu.*``.
"""

from __future__ import annotations

#: published peaks of one H100 SXM (NVIDIA data sheet): f32 outside the
#: tensor cores, and HBM bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
#: instruction rates of the card's FP32 pipe (a fused multiply-add is one
#: instruction and two of the 67e12 flops) and of its MUFU unit (16 results
#: per clock per SM against 128 FP32 lanes)
FP32_INSTR_PER_S = PEAK_F32_FLOPS / 2
MUFU_PER_S = PEAK_F32_FLOPS / 16


def _pow_muls(n: int) -> int:
    """Multiplies of x**n by repeated squaring."""
    return n.bit_length() - 1 + bin(n).count("1") - 1


def _side_cost(sig: float, a: float, b: float, periodic: bool,
               grad: bool) -> tuple[int, int]:
    """FP32-pipe instructions and MUFU operations of one side's sigmoid on
    one pair, evaluated as cheaply as is correct: t = (r/sig)^a, c t,
    u = 1 + c t, and s = 1 - u^e without the cancellation of 1 - u^e near
    u = 1. With w = 1/u its sum is a Horner chain of positive terms:
    e = -n, s = c t w (1 + w (1 + ... w)), n - 1 FMAs; e = -(n + 1/2),
    s = c t w (1 + ... w (1 + h)), n FMAs, with h = (1 - u^-1/2) / (c t) =
    u^-1/2 / (1 + u u^-1/2); other e, 1 - powf. With ``grad`` also s'(r)/r
    from u^(e-1). A reciprocal, rsqrt or sqrt is one MUFU operation; powf
    two (lg2, ex2) and a multiply."""
    fp, mufu = 0, 0
    int_a = a == int(a) and 1 <= a <= 64
    if not periodic and int_a and int(a) % 2 == 0:
        fp += 1 + _pow_muls(int(a) // 2)         # (r^2 / sig^2)^(a/2)
    else:
        mufu += 1                                # sqrt
        fp += 2 if periodic else 1               # + 1e-12, times 1/sig
        fp, mufu = (fp + _pow_muls(int(a)), mufu) if int_a else (fp + 1, mufu + 2)
    fp += 2                                      # c t, u
    m = b / a
    if m == int(m) and 1 <= m <= 16:             # e = -n: w; the chain, times c t
        n = int(m)
        mufu += 1
        fp += n + (_pow_muls(n + 1) if grad else 0)  # grad: u^(e-1) = w^(n+1)
    elif m - 0.5 == int(m - 0.5) and m <= 16.5:  # e = -(n + 1/2): u^-1/2; h (an FMA,
        n = int(m - 0.5)                         # a reciprocal, a multiply); w
        mufu += 3 if n else 2                    # where n > 0; the chain, times c t
        fp += n + 3
        if grad:                                 # u^(e-1) = u^-1/2 w^(n+1), or
            fp += _pow_muls(n + 1) + 1 if n else 2  # (u^-1/2)^3 where n = 0
    else:                                        # 1 - powf(u, e)
        mufu += 3 if grad else 2                 # grad: w
        fp += 3 if grad else 2                   # grad: u^(e-1) = u^e w
    if grad:
        fp += 1                                  # times b c [/ sig^2]
        if a != 2:
            mufu += 1                            # 1 / r^2
            fp += 2
    return fp, mufu


def sigmoid_pair_cost(D: int, d: int, periodic: bool, backward: bool,
                      params: tuple) -> tuple[int, int]:
    """FP32-pipe instructions and MUFU operations per unordered pair of the
    sketch-map loss's cheapest correct evaluation at these parameters: the
    component differences and squares (2 per Euclidean component, 6 per
    min-image one: difference, P - |t|, min, the zero guard's compare and
    select, square-add), both sigmoids, then the squared difference
    (forward) or the pair term with its zero mask and the row and column
    partials of all d + 1 sums (backward)."""
    fh, mh = _side_cost(*params[:3], periodic, False)
    fl, ml = _side_cost(*params[3:], False, backward)
    fp = (6 if periodic else 2) * D + 2 * d + fh + fl
    fp += 2 + 2 + 2 * (d + 1) if backward else 2
    return fp, mh + ml


def sigmoid_bound(B: int, D: int, d: int, periodic: bool, backward: bool,
                  params: tuple) -> tuple[float, str, str]:
    """The least time of one sketch-map loss pass: the larger of its
    unordered pairs' FP32 instructions over the FP32 pipe's rate, their
    MUFU operations over the MUFU rate, and the bytes (inputs read once,
    output written once) over the memory rate. Returns ms, ``bound_by`` and
    the pipe."""
    pairs = B * (B + 1) // 2
    fp, mufu = sigmoid_pair_cost(D, d, periodic, backward, params)
    nbytes = 4 * B * (D + (2 * d if backward else d)) + 4
    times = {"FP32": pairs * fp / FP32_INSTR_PER_S, "MUFU": pairs * mufu / MUFU_PER_S,
             "bytes": nbytes / PEAK_BYTES_PER_S}
    pipe = max(times, key=times.get)
    return 1e3 * times[pipe], "bytes" if pipe == "bytes" else "operations", pipe


def fused_step_cost(dims: list, n_enc: int, B: int, d0: int, periodic: bool,
                    n_params: int, params: tuple) -> tuple[int, int]:
    """FP32-pipe instructions and MUFU operations of one EncoderMap train
    step: the forward, delta and weight-gradient products (one FFMA per
    multiply-add each); the sketch-map pairs (each unordered pair once,
    ``sigmoid_pair_cost`` with the latent gradient on the raw d0 columns,
    plus the loss's squared difference and sum); Adam (seven FP32
    instructions and two MUFU operations, sqrt and reciprocal, per
    parameter). The MLP's tanh and the periodic sin/cos and atan2 are left
    out: the bound stays a floor."""
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    pairs = B * (B + 1) // 2
    fp, mufu = sigmoid_pair_cost(d0, dims[n_enc], periodic, True, params)
    return (3 * B * macs + pairs * (fp + 2) + 7 * n_params,
            pairs * mufu + 2 * n_params)


# ---------------------------------------------------------------- added here
def mlp_dims(in_dim: int, n_neurons: list, out_dim: int) -> tuple[list, int]:
    """``(dims, n_enc)`` of EncoderMap's dense stack: ``in_dim``, the
    encoder's ``n_neurons``, the decoder's mirror of them and ``out_dim``."""
    dims = [in_dim] + list(n_neurons) + list(n_neurons[-2::-1]) + [out_dim]
    return dims, len(n_neurons)


def n_params(dims: list) -> int:
    """Kernels and biases of a dense stack."""
    return sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))


def fused_step_least_s(dims: list, n_enc: int, B: int, d0: int,
                       periodic: bool, params: tuple) -> tuple[float, str]:
    """Least seconds of one EncoderMap train step, whatever kernels compute
    it: the larger of ``fused_step_cost``'s FP32 and MUFU times and the
    bytes a step must move (parameters and both moments in and out, the
    batch's rows, its indices, five metrics) over the memory rate."""
    P = n_params(dims)
    fp, mufu = fused_step_cost(dims, n_enc, B, d0, periodic, P, params)
    t_ops = max(fp / FP32_INSTR_PER_S, mufu / MUFU_PER_S)
    t_bytes = (4 * (6 * P + B * d0 + 5) + 8 * B) / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def sigmoid_pair_flops(D: int, d: int, periodic: bool, params: tuple) -> int:
    """FLOPs counted per unordered pair of one sketch-map loss's forward
    and backward: the FP32 instructions of ``sigmoid_pair_cost``, each as
    one FLOP (a floor: a fused multiply-add counts once, not twice)."""
    return (sigmoid_pair_cost(D, d, periodic, False, params)[0]
            + sigmoid_pair_cost(D, d, periodic, True, params)[0])


def dense_flops(dims: list, B: int) -> int:
    """The dense layers' products of one step: 2 FLOPs a multiply-add, for
    the forward product and both backward products."""
    return 6 * B * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


#: FLOPs per atom and sample of the backmap, forward and backward: the
#: planar chain (a turn, its cos and sin, a scaled bond, a cumulative sum:
#: about 10), one quaternion product (28) and one rotated bond (about 30)
#: per dihedral, its cumulative sum (3), and twice that for the backward
BACKMAP_FLOPS_PER_ATOM = 3 * (10 + 28 + 30 + 3)
#: FLOPs per atom pair and sample of the Cartesian cost, forward and
#: backward: two distances (8 each and a square root), their absolute
#: difference (2), and the backward through both distances (about 20)
CARTESIAN_FLOPS_PER_PAIR = 2 * 9 + 2 + 20


def em_model_flops(dims: list, B: int, d0: int, periodic: bool,
                   params: tuple) -> int:
    """Model FLOPs of one EncoderMap step: the dense products and the
    sketch-map pairs of the raw ``d0`` input columns against the latent."""
    pairs = B * (B + 1) // 2
    d = min(dims)
    return dense_flops(dims, B) + pairs * sigmoid_pair_flops(d0, d, periodic, params)


def adc_model_flops(dims: list, B: int, enc_d: int, n_atoms: int, n_ca: int,
                    params: tuple, ca_params: tuple) -> int:
    """Model FLOPs of one ADC step: the dense products, the encoder
    input's sketch-map pairs (periodic, ``enc_d`` raw columns), the CA
    pairs' sketch-map pairs (the ``n_ca (n_ca - 1) / 2`` flat distances,
    the least width that holds them), the backmap and the Cartesian cost
    of the CA pairs."""
    pairs = B * (B + 1) // 2
    d = min(dims)
    ca_pairs = n_ca * (n_ca - 1) // 2
    return (dense_flops(dims, B)
            + pairs * sigmoid_pair_flops(enc_d, d, True, params)
            + pairs * sigmoid_pair_flops(ca_pairs, d, False, ca_params)
            + B * n_atoms * BACKMAP_FLOPS_PER_ATOM
            + B * ca_pairs * CARTESIAN_FLOPS_PER_PAIR)
