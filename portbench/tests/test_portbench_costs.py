"""The frozen counts against hand-worked values, and against the bring-up
proof's functions they were copied from."""

import itertools

import pytest

from portbench import costs, readers

SIG = (4.5, 12, 6, 1, 2, 6)


def test_side_costs_by_hand():
    # high side, a = 12 on the line: (r^2/sig^2)^6 by 3 multiplies and 1;
    # c t, u; e = -1/2: u^-1/2, h, no w; 3 FP32
    assert costs._side_cost(4.5, 12, 6, False, False) == (9, 2)
    # latent side, a = 2: 1 multiply; c t, u; e = -3: w and a chain of 3;
    # the gradient adds w^4 (2 multiplies) and the factor b c / sig^2
    assert costs._side_cost(1, 2, 6, False, False) == (6, 1)
    assert costs._side_cost(1, 2, 6, False, True) == (9, 1)


def test_pair_costs_by_hand():
    # 2 per Euclidean component (D = 3) and per latent one (d = 2), both
    # sides, then the squared difference and its sum
    assert costs.sigmoid_pair_cost(3, 2, False, False, SIG) == (27, 3)
    # backward: the pair term, its mask, and the d + 1 partial sums twice
    assert costs.sigmoid_pair_cost(3, 2, False, True, SIG) == (38, 3)
    # a min-image component costs 6; the periodic high side takes r by a
    # square root (a MUFU operation), adds 1e-12 and scales by 1/sig, and
    # takes r^12 by 4 multiplies: 11 FP32 and 3 MUFU against 9 and 2
    assert costs.sigmoid_pair_cost(3, 2, True, False, SIG) == (27 + 4 * 3 + 2, 4)


def test_sigmoid_bound_by_hand():
    # B = 4: 10 unordered pairs; the bytes (84) bound it at this size
    ms, by, pipe = costs.sigmoid_bound(4, 3, 2, False, False, SIG)
    assert (by, pipe) == ("bytes", "bytes")
    assert ms == pytest.approx(1e3 * 84 / costs.PEAK_BYTES_PER_S)
    ms, by, pipe = costs.sigmoid_bound(256, 3, 2, False, False, SIG)
    assert (by, pipe) == ("operations", "FP32")
    assert ms == pytest.approx(1e3 * 256 * 257 / 2 * 27 / costs.FP32_INSTR_PER_S)


def test_fused_step_cost_by_hand():
    dims, n_enc = costs.mlp_dims(8, [4, 2], 8)
    assert (dims, n_enc) == ([8, 4, 2, 4, 8], 2)
    P = costs.n_params(dims)
    assert P == 8 * 4 + 4 + 4 * 2 + 2 + 2 * 4 + 4 + 4 * 8 + 8
    fp, mufu = costs.fused_step_cost(dims, n_enc, 2, 4, True, P, SIG)
    pair_fp, pair_mufu = costs.sigmoid_pair_cost(4, 2, True, True, SIG)
    assert fp == 3 * 2 * (32 + 8 + 8 + 32) + 3 * (pair_fp + 2) + 7 * P
    assert mufu == 3 * pair_mufu + 2 * P


def test_model_flops_by_hand():
    dims = [8, 4, 2, 4, 8]
    assert costs.dense_flops(dims, 2) == 6 * 2 * 80
    pair = costs.sigmoid_pair_flops(4, 2, True, SIG)
    assert costs.em_model_flops(dims, 2, 4, True, SIG) == 6 * 2 * 80 + 3 * pair
    adc = costs.adc_model_flops(dims, 2, 4, 6, 3, SIG, SIG)
    assert adc == (6 * 2 * 80 + 3 * pair + 3 * costs.sigmoid_pair_flops(3, 2, False, SIG)
                   + 2 * 6 * costs.BACKMAP_FLOPS_PER_ATOM
                   + 2 * 3 * costs.CARTESIAN_FLOPS_PER_PAIR)


def test_least_step_time_takes_the_larger_bound():
    dims, n_enc = costs.mlp_dims(8, [128, 128, 2], 8)
    s, by = costs.fused_step_least_s(dims, n_enc, 256, 4, True, SIG)
    fp, mufu = costs.fused_step_cost(dims, n_enc, 256, 4, True, costs.n_params(dims), SIG)
    assert by == "operations"
    assert s == max(fp / costs.FP32_INSTR_PER_S, mufu / costs.MUFU_PER_S)


def test_the_adc_sigmoid_bound_counts_both_losses_at_their_flat_widths():
    s = {"family": "adc", "B": 256, "enc_d": 152, "dims": [304, 128, 128, 2, 128, 128, 304],
         "n_ca": 20, "sig": SIG, "ca_sig": SIG}
    want = sum(costs.sigmoid_bound(256, D, 2, per, back, SIG)[0]
               for D, per in ((152, True), (190, False)) for back in (False, True))
    assert readers.sigmoid_least_ms(s) == pytest.approx(want)


def test_the_copy_equals_the_bring_up_proof():
    cs = pytest.importorskip("chip_smoke")
    assert (cs.PEAK_F32_FLOPS, cs.PEAK_BYTES_PER_S) == (costs.PEAK_F32_FLOPS,
                                                        costs.PEAK_BYTES_PER_S)
    for D, d, per, back in itertools.product((1, 3, 57, 1229), (2, 3), (False, True),
                                             (False, True)):
        assert cs.sigmoid_pair_cost(D, d, per, back, SIG) == \
            costs.sigmoid_pair_cost(D, d, per, back, SIG)
        assert cs.sigmoid_bound(256, D, d, per, back, SIG) == \
            costs.sigmoid_bound(256, D, d, per, back, SIG)
    dims = [8, 128, 128, 2, 128, 128, 8]
    assert cs.fused_step_cost(dims, 3, 256, 4, True, 35000, SIG) == \
        costs.fused_step_cost(dims, 3, 256, 4, True, 35000, SIG)
