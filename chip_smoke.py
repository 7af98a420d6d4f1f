#!/usr/bin/env python3
# chip_smoke.py
"""Smoke test of the PyTorch/CUDA port (encodermap_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/, holds each against its plain
PyTorch version on the card (both fused train kernels, the cluster kernel
and the grid kernel, at the main configuration and at batch 288, timed in
turns there, and the grid kernel where the router sends it: batches 1000,
1024, 4096 and 16384, widths [256,256,2]), drives EncoderMap training end to
end through the kernels (fused route on cube and on periodic dihedral data
at batch 256, and on cube at 1024 through the grid kernel; general route at
batch 16384, and its step at 1024 beside the grid
kernel's), drives the AngleDihedralCartesianEncoderMap
(ADC) trainer on synthetic backbones at trp-cage scale (20 residues, the
full width of BASELINE config 3), at 158 residues (the CA distance-matrix
rows, 24,964 wide, on the sigmoid-loss kernels) and at 512 residues (the
analytic Cartesian route), then in its two further modes at trp-cage
scale: sidechain reconstruction (every atom of trp-cage backmapped inside
the step) and multimer training (a trp-cage homodimer placed by decoded
transforms). Its last leg is BASELINE config 4: a synthetic M1-linked
diubiquitin written as PDB + XTC, loaded and featurized on the card (held
against the CPU), the ADC trained on the trajectory ensemble itself, and
conformations generated onto the topology by the rotation sweep. The
analysis leg follows on the same diUbi frames: written as DCD, TRR and GRO
and read back, featurized from DCD + TRR, secondary structure (DSSP) on the
card over all frames, ``MolData``, the pairwise-RMSD matrix and a latent
cluster's centroid, and a reconstruct-sidechain ADC trained on a trp-cage
trajectory ensemble and generated onto its topology. Then
BASELINE config 5: ``train_streaming`` over a million-frame memmap at
[128,128,2], B=256, 1000-step superbatches (pinned uploads on a side
stream, held bit for bit to the in-memory chunk trainer), the ADC streaming
diUbi CV superbatches, and a one-rank NCCL group that trains config 5 with
``mesh_shape={"dp": 1}`` through the data-parallel gather path and runs
``ShardedFeaturizer``. The tensor-parallel leg starts two processes on the
card as a ``dp=1 x tp=2`` gloo mesh (``python3 chip_smoke.py --tp-worker
<rank> <dir>`` is one of them), trains a ``shard_params_tp`` state of
config 1 for 100 steps and one trp-cage ADC step, and holds both to the
same steps on one device. ``phase_adc`` also holds the trained ADC's step
gradients to the float64 oracle ``ops/adc_adjoint.py::hand_adc_step`` on
the card (the kernels within 3x of the plain version's distance from
it), and holds the backmap's one-way kernels against their plain versions
at trp-cage's and ubiquitin's two halves and at 236 bonds, B=256
(``hold_one_way``), and
the sidechain leg the sidechain backmap's kernels at trp-cage, B=256
(``hold_sidechain``), and the clip + Adam kernel bit for bit against its
plain version at both ADC configurations' leaves (``hold_clip_adam``);
every ADC leg checks how often they launch. The observability leg trains config
1 with TensorBoard events, the model summary and a latent-histogram image written
by a callback, reads the event file back (CRCs, tags, steps, float32
values equal to the JSONL rows), trains the ADC with TensorBoard on,
profiles two chunks (the cluster kernel named in the trace), and times
``block_timer`` and ``function`` on the card. It holds the sigmoid-loss
kernels against their plain versions at each ADC width and at config 5's,
and checks what comes out. Prints one JSON
line per kernel set before the last line, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``. Any failed check
raises, so the exit code is non-zero and no result line is printed.
Without a CUDA card it exits with code 2 at once.
"""

from __future__ import annotations

import json
import math
import re
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
#: published peaks of one H100 SXM (NVIDIA data sheet): f32 outside the
#: tensor cores, and HBM bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
#: instruction rates of the card's FP32 pipe (a fused multiply-add is one
#: instruction and two of the 67e12 flops) and of its MUFU unit (16 results
#: per clock per SM against 128 FP32 lanes)
FP32_INSTR_PER_S = PEAK_F32_FLOPS / 2
MUFU_PER_S = PEAK_F32_FLOPS / 16


def log(*args) -> None:
    print(*args, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call on the card (CUDA events, after warmup)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _pow_muls(n: int) -> int:
    """Multiplies of x**n by repeated squaring."""
    return n.bit_length() - 1 + bin(n).count("1") - 1


def _side_cost(sig: float, a: float, b: float, periodic: bool,
               grad: bool) -> tuple[int, int]:
    """FP32-pipe instructions and MUFU operations of one side's sigmoid on
    one pair, evaluated as cheaply as is correct: t = (r/sig)^a, c t,
    u = 1 + c t, and s = 1 - u^e without the cancellation of 1 - u^e near
    u = 1 (the function of csrc/sigmoid_pairs.cuh's ``sig_s``; 1 - y with
    y = u^e biased the grid train kernel's training, PERF.md). With w = 1/u
    its sum is a Horner chain of positive terms: e = -n, s = c t w (1 + w (1
    + ... w)), n - 1 FMAs; e = -(n + 1/2), s = c t w (1 + ... w (1 + h)), n
    FMAs, with h = (1 - u^-1/2) / (c t) = u^-1/2 / (1 + u u^-1/2); other e,
    1 - powf. With ``grad`` also s'(r)/r from u^(e-1). A reciprocal, rsqrt
    or sqrt is one MUFU operation; powf two (lg2, ex2) and a multiply."""
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
    sigmoid-loss kernels' cheapest correct evaluation at these parameters:
    the component differences and squares (2 per Euclidean component, 6 per
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
    """The least time of one sigmoid-loss kernel: the larger of its
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
    """FP32-pipe instructions and MUFU operations of one fused train step:
    the forward, delta and weight-gradient products (one FFMA per
    multiply-add each); the sketch-map pairs as the sigmoid-loss kernels'
    bound counts them (each unordered pair once, ``sigmoid_pair_cost`` with
    the latent gradient on the raw d0 columns, plus the loss's squared
    difference and sum); Adam (seven FP32 instructions and two MUFU
    operations, sqrt and reciprocal, per parameter). The MLP's tanh and the
    periodic sin/cos and atan2 are left out: the bound stays a floor."""
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    pairs = B * (B + 1) // 2
    fp, mufu = sigmoid_pair_cost(d0, dims[n_enc], periodic, True, params)
    return (3 * B * macs + pairs * (fp + 2) + 7 * n_params,
            pairs * mufu + 2 * n_params)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ----------------------------------------------------------------- phases
def sass_sizes(_build, name: str) -> dict:
    """Machine instructions per kernel of a built library (cuobjdump beside
    nvcc), 16 bytes each: a step's code has to stay under the SM's
    instruction cache (scripts/cluster_microbench.cu)."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    if not cuobjdump.exists():
        return {}
    text = subprocess.run([str(cuobjdump), "-sass", str(_build._library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    return {part.split()[0]: len(re.findall(r"^\s+/\*[0-9a-f]{4,}\*/", part, re.M))
            for part in text.split("Function : ")[1:]}


def ptxas_kernels(text: str) -> dict:
    """Registers and spilled bytes per kernel from ``-Xptxas -v`` output,
    by the kernel's name with its template arguments (P, periodic)."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            base = re.search(r"\d+([a-z_]+_kernel)(?:ILi(\d+)ELb(\d)E)?", m.group(1))
            name = base.group(1) if base is None or base.group(2) is None else \
                f"{base.group(1)}<{base.group(2)}, {base.group(3)}>"
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name]["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def sigmoid_build_info(_build, text: str) -> None:
    """Each sigmoid-loss kernel's registers and spills, and the tile
    kernels' blocks per SM at the widths phase_sigmoid runs (CUDA's
    occupancy calculator); fails if a tile kernel spills. ``text`` is the
    library's compiler log, this run's or the one kept beside a library
    built before."""
    kernels = ptxas_kernels(text)
    check(sum(k.startswith("sigmoid_") for k in kernels) == 8,
          "sigmoid_loss: the compiler log does not list its 8 tile kernels")
    lib = _build.load_library("sigmoid_loss")
    for name, info in sorted(kernels.items()):
        line = f"[build] sigmoid_loss {name}: {info.get('registers')} registers, " \
               f"{info.get('spill')} bytes spilled"
        m = re.match(r"sigmoid_(fwd|bwd)_kernel<(\d), (\d)>", name)
        if m:
            bwd, tile, periodic = m.group(1) == "bwd", 64 * int(m.group(2)), int(m.group(3))
            shapes = (4, 30, 128) if periodic else (3,)
            occ = ", ".join(f"D={D}: {lib.em_sigmoid_occupancy(int(bwd), periodic, tile, D, 2)}"
                            for D in shapes)
            line += f"; T={tile}, blocks per SM at d=2 {occ}"
            check(info.get("spill") == 0, f"{name} spills")
        log(line)


def phase_build(_build) -> None:
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {sorted(logs)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc -gencode arch=compute_90a,code=sm_90a)")
    for name, text in logs.items():
        if name == "sigmoid_loss":
            continue
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    sigmoid_build_info(_build, logs.get("sigmoid_loss", ""))
    sizes = sass_sizes(_build, "fused_train_cluster")
    for kernel, n in sizes.items():
        log(f"[build] {kernel}: {n} instructions, {16 * n / 1024:.0f} KB of code")
    if not sizes:
        log("[build] code size: not measured (no cuobjdump beside nvcc)")


SIGMOID_SHAPES = ((3, float("inf")), (4, 2 * math.pi), (30, 2 * math.pi),
                  (128, 2 * math.pi))


def hold_sigmoid(fs, h, l, params: tuple, periodicity: float, label: str,
                 reps: int = 5, plain_reps: int = 3, plain_warmup: int = 1,
                 oracle: bool = False) -> dict:
    """Kernels 2 and 3 against their plain versions on ``(h, l)``: the loss
    to 1e-5 relative and the latent gradient to 1e-4 of its largest entry
    (f32 sums of B(B+1)/2 pair terms, and of B terms per gradient row, in
    another order than torch's), and the same bits on two launches. Times
    both by CUDA events; returns (abs err, ms, plain ms, bound) per
    direction.

    ``oracle=True`` holds the gradient to the plain version in float64
    instead, by the port's rule for kernel gradients (ROADMAP.md, port
    rules): err(kernel, f64) <= 3 err(plain f32, f64), each relative to the
    largest entry of the f64 gradient. It is for inputs whose gradient rows
    sum terms that cancel, where the plain float32 gradient itself strays
    from float64 by more than 1e-4 of its largest entry (config 4's)."""
    (B, D), d = h.shape, l.shape[1]
    periodic = math.isfinite(periodicity)
    v_k = fs.sigmoid_loss_fwd(h, l, params, periodicity)
    v_p = fs.sigmoid_loss_fwd_plain(h, l, params, periodicity)
    g_k = fs.sigmoid_loss_bwd(h, l, params, periodicity)
    g_p = fs.sigmoid_loss_bwd_plain(h, l, params, periodicity)
    same = (torch.equal(v_k, fs.sigmoid_loss_fwd(h, l, params, periodicity))
            and torch.equal(g_k, fs.sigmoid_loss_bwd(h, l, params, periodicity)))
    torch.cuda.synchronize()
    f_abs = abs(float(v_k) - float(v_p))
    f_rel = f_abs / abs(float(v_p))
    b_abs = float((g_k - g_p).abs().max())
    b_rel = b_abs / float(g_p.abs().max())
    if oracle:
        g_64 = fs.sigmoid_loss_bwd_plain(h.double(), l.double(), params, periodicity)
        scale = float(g_64.abs().max())
        b_abs = float((g_k.double() - g_64).abs().max())
        b_rel = b_abs / scale
        p_rel = float((g_p.double() - g_64).abs().max()) / scale
    ms_f = time_ms(lambda: fs.sigmoid_loss_fwd(h, l, params, periodicity), reps)
    ms_fp = time_ms(lambda: fs.sigmoid_loss_fwd_plain(h, l, params, periodicity),
                    plain_reps, plain_warmup)
    ms_b = time_ms(lambda: fs.sigmoid_loss_bwd(h, l, params, periodicity), reps)
    ms_bp = time_ms(lambda: fs.sigmoid_loss_bwd_plain(h, l, params, periodicity),
                    plain_reps, plain_warmup)
    bf = sigmoid_bound(B, D, d, periodic, False, params)
    bb = sigmoid_bound(B, D, d, periodic, True, params)
    log(f"[{label}] fwd kernel {float(v_k):.8f} plain {float(v_p):.8f} "
        f"abs {f_abs:.3e} rel {f_rel:.3e} | {ms_f:.4f} ms (plain {ms_fp:.3f} ms, "
        f"bound {bf[0]:.5f} ms {bf[2]})")
    log(f"[{label}] bwd max abs {b_abs:.3e} rel-to-max {b_rel:.3e}"
        + (f" against float64 (plain float32 {p_rel:.3e})" if oracle else "")
        + f" | {ms_b:.4f} ms (plain {ms_bp:.3f} ms, bound {bb[0]:.5f} ms {bb[2]}); "
        f"two launches bit-identical {same}")
    check(f_rel <= 1e-5, f"{label} fwd: rel err {f_rel}")
    if oracle:
        check(b_rel <= 3 * p_rel, f"{label} bwd: {b_rel} from float64, plain {p_rel}")
    else:
        check(b_rel <= 1e-4, f"{label} bwd: rel err {b_rel}")
    check(same, f"{label}: two launches differ")
    return dict(fwd=(f_abs, ms_f, ms_fp, bf), bwd=(b_abs, ms_b, ms_bp, bb))


def phase_sigmoid(fs, _build) -> dict:
    """Kernels 2 and 3 against their plain versions at B=16384, d=2: cube
    D=3, dihedral widths 4 and 30, and 128, the width of a dihedral model
    that only the general route takes (more than 32 input columns)."""
    B, d = 16384, 2
    params = (4.5, 12, 6, 1, 2, 6)
    out = {}
    for D, periodicity in SIGMOID_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(D)
        if math.isfinite(periodicity):
            h = (torch.rand((B, D), generator=g, device="cuda") * 2 - 1) * math.pi
        else:
            h = torch.rand((B, D), generator=g, device="cuda")
        l = torch.randn((B, d), generator=g, device="cuda")
        tag = f"D={D} {'periodic' if math.isfinite(periodicity) else 'euclid'}"
        out[tag] = hold_sigmoid(fs, h, l, params, periodicity, f"sigmoid {tag}")
    return out


def phase_router(fs) -> dict:
    """Forward + backward of the sketch-map loss through the kernels and
    through the general path (pairwise distances, autograd), from the main
    configuration's B=256 down to 64 and up to 16384: ``fused_or_reference``
    takes the kernels at every size on the card. Returns the kernels' and
    the general path's ms by (D, B)."""
    params = (4.5, 12, 6, 1, 2, 6)
    out = {}
    for D, periodicity in ((3, float("inf")), (4, 2 * math.pi)):
        for B in (64, 256, 1024, 4096, 16384):
            g = torch.Generator(device="cuda").manual_seed(B)
            h = torch.rand((B, D), generator=g, device="cuda")
            l = torch.randn((B, 2), generator=g, device="cuda")

            def kernels():
                x = l.detach().requires_grad_(True)
                fs.fused_sigmoid_loss(h, x, params, periodicity).backward()

            def general():
                x = l.detach().requires_grad_(True)
                fs.sigmoid_loss_general(h, x, params, periodicity).backward()

            reps = 20 if B <= 1024 else 3
            ms_k, ms_g = time_ms(kernels, reps), time_ms(general, reps)
            log(f"[router D={D} {'periodic' if math.isfinite(periodicity) else 'euclid'} "
                f"B={B}] fwd+bwd kernels {ms_k:.4f} ms, general path {ms_g:.4f} ms")
            check(ms_k < ms_g, f"router D={D} B={B}: the general path is faster "
                  f"than the kernels the router takes on the card")
            out[D, B] = (ms_k, ms_g)
    return out


def _fused_data(em, d0: int, periodic: bool) -> tuple:
    """The fused route's data, uniform dihedrals or the 3-cube's 125,000
    points (numpy), and the RNG that draws its batches next."""
    rng = np.random.default_rng(d0)
    if periodic:
        data = rng.uniform(-np.pi, np.pi, (125000, d0))
    else:
        data = em.create_n_cube(3, points_along_edge=500, seed=0)[0]
    return data, rng


def _fused_weights(em, ft, d0: int, periodic: bool, B: int) -> tuple:
    """The fused route's parameters at [128,128,2] from seed 0 for d0 input
    columns: ``(p, flat, n_enc, zeros)``."""
    from encodermap_tpu_torch.models import sequential as seq

    p = em.Parameters(n_neurons=[128, 128, 2], batch_size=B,
                      periodicity=2 * math.pi if periodic else float("inf"))
    gen = torch.Generator().manual_seed(0)
    params = seq.init_params(gen, p, d0, device="cuda")
    flat, n_enc = ft.split_params(params)
    return p, flat, n_enc, [torch.zeros_like(t) for t in flat]


def _fused_setup(em, ft, d0: int, periodic: bool, steps: int, B: int = 256):
    p, flat, n_enc, zeros = _fused_weights(em, ft, d0, periodic, B)
    data, rng = _fused_data(em, d0, periodic)
    data = torch.as_tensor(data, dtype=torch.float32, device="cuda")
    idx = torch.as_tensor(rng.integers(0, len(data), (steps, B)),
                          device="cuda")
    return p, flat, n_enc, zeros, data, idx


def _max_err(a: list, b: list) -> float:
    return max(float((x.double() - y.double()).abs().max()) for x, y in zip(a, b))


def _rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(((a.double() - b.double()).abs() / b.double().abs()).max())


def _rel_to_max(a: list, b: list) -> float:
    """Largest error of each tensor relative to its own largest entry."""
    return max(float((x.double() - y.double()).abs().max() / y.double().abs().max())
               for x, y in zip(a, b))


FUSED_KERNELS = ("fused_train_cluster", "fused_train")
#: how much slower than the grid kernel the routed cluster kernel may time
#: at [128,128,2] B=256, where the two are close: the cluster kernel led by
#: 4 % (95.4 against 99.8 us a step on the H100), and the grid kernel's
#: time there ranged over 90.5-100.8 us across its development versions
#: (PERF.md); at B=288 (22 % apart) the routed kernel may not be slower
ROUTE_MARGIN_B256 = 0.10


def _fused_bound(ft, flat, data, idx, n_enc: int, d0: int, periodic: bool,
                 params: tuple) -> tuple:
    """Bound of a chunk, the same for both fused kernels: the larger of its
    steps' FP32 instructions over the FP32 pipe's rate, their MUFU
    operations over the MUFU rate (``fused_step_cost``), and the bytes it
    must move (parameters and moments in and out, the dataset, the metrics,
    the indices) over the memory rate; and the operations' time at the
    cluster kernel's own share of the card (ft.CLUSTER of 132 SMs). Returns
    ``((ms, bound_by), cluster_ms)``."""
    steps, B = idx.shape
    dims = [flat[0].shape[0]] + [w.shape[1] for w in flat[:len(flat) // 2]]
    n_params = sum(t.numel() for t in flat)
    fp, mufu = fused_step_cost(dims, n_enc, B, d0, periodic, n_params, params)
    t_ops = steps * max(fp / FP32_INSTR_PER_S, mufu / MUFU_PER_S)
    nbytes = 4 * (6 * n_params + data.numel() + steps * 5) + 8 * idx.numel()
    t_bytes = nbytes / PEAK_BYTES_PER_S
    bound = (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    return bound, 1e3 * t_ops * 132 / ft.CLUSTER


def phase_fused(em, ft, B: int, hold_both: bool = True, margin: float = 0.0) -> dict:
    """The fused train kernels against their plain version at [128,128,2]
    and batch B, a shape either can run: 1 step, 5 steps tightly, 100 steps
    against a float64 run of the plain version, a second 100-step run bit
    for bit; with ``hold_both`` also the cluster kernel against float64 on
    F64_SEEDS after F64_STEPS (``fused_drift_runs``, ``hold_f64``'s gate);
    then both kernels' time on the same 500-step chunk, and each kernel's
    split of a step by phase. Fails if the kernel fused_route picks
    for the shape is slower than the other by more than ``margin`` (a
    share of the other's time). With ``hold_both`` false only that
    kernel is held, and not to the 100-step float64 rule: at B=288 on the
    cube the two kernels leave the float64 run alike between steps 60 and
    100, a turn of the float32 trajectory that the plain float32 version
    does not take on these batches but takes on others
    (``scripts/fused_f64_drift.py --seeds``, PERF.md); the rule holds both
    kernels at B=256 and the grid kernel at B=1024."""
    out = {}
    for d0, periodic in ((3, False), (4, True)):
        tag = f"{'periodic d0=4' if periodic else 'cube d0=3'} B={B}"
        p, flat, n_enc, zeros, data, idx = _fused_setup(em, ft, d0, periodic, 100, B=B)
        hyper = ft.hyper_from(p)
        kw = dict(n_enc=n_enc, hyper=hyper)
        _, mp1, vp1, _ = ft.fused_chunk_plain(flat, zeros, zeros, 0.0, data, idx[:1], **kw)
        pp5, mp5, vp5, met_p5 = ft.fused_chunk_plain(flat, zeros, zeros, 0.0, data,
                                                     idx[:5], **kw)
        dims = [flat[0].shape[0]] + [w.shape[1] for w in flat[:len(flat) // 2]]
        routed = ft.fused_route(dims, n_enc, B, d0)
        held = FUSED_KERNELS if hold_both else (routed,)
        res = fused_f64_runs(ft, flat, zeros, kw, data, idx, held)[100]
        dist = f64_distances(res)
        (pp, op, _), pd = res["plain f32"], dist["plain f32"]
        errs = {}
        for kernel in held:
            kkw = dict(kw, kernel=kernel)
            name = f"[fused {tag} {kernel}]"
            # 1 step: both take the gradient at the same parameters, so the
            # moments (0.1 g and 0.001 g^2, g clipped) differ only by the
            # order of f32 sums: held to 1e-4 of each tensor's largest
            # entry. Adam's step hides a gradient's scale; these moments
            # show it
            _, mk, vk, _ = ft.fused_chunk(flat, zeros, zeros, 0.0, data, idx[:1], **kkw)
            m1 = _rel_to_max(mk + vk, mp1 + vp1)
            log(f"{name} 1 step: moments max rel-to-max {m1:.3e}")
            check(m1 <= 1e-4, f"{name} 1-step moments mismatch")

            # 5 steps: f32 sums in another order; Adam divides each
            # gradient by its own magnitude, so an element whose gradient
            # is near zero can move by a good part of lr = 1e-3 on a
            # rounding difference: params are held to a tenth of one step,
            # the losses to 1e-4 relative, the moments to 1e-3 of each
            # tensor's largest entry, as later gradients are taken at
            # parameters that already differ
            pk, mk, vk, met_k = ft.fused_chunk(flat, zeros, zeros, 0.0, data, idx[:5],
                                               **kkw)
            e5, r5 = _max_err(pk, pp5), _rel_err(met_k, met_p5)
            m5 = _rel_to_max(mk + vk, mp5 + vp5)
            log(f"{name} 5 steps: params max abs {e5:.3e}, moments max rel-to-max "
                f"{m5:.3e}, metrics max rel {r5:.3e}")
            check(e5 <= 1e-4 and r5 <= 1e-4 and m5 <= 1e-3, f"{name} 5-step mismatch")

            # 100 steps: training on periodic data amplifies rounding (the
            # plain version in f32 and in f64 part by ~1e-2), so the kernel
            # is held to three times the plain f32 version's own distance
            # from f64, plus the 5-step bounds. On periodic data the plain
            # moments' own distance is of the order of the moments, so there
            # the moment check bounds nothing: the 1- and 5-step checks hold
            # the moments
            pk, ok, met_k = res[kernel]
            check(bool(torch.isfinite(met_k).all()), f"{name} non-finite metrics")
            err_p = _max_err(pk, pp)
            err_m = _max_err(ok, op)
            dk = dist[kernel]
            log(f"{name} 100 steps: kernel-plain params {err_p:.3e}, moments "
                f"{err_m:.3e}; vs f64: kernel params {dk['params']:.3e} moments "
                f"{dk['moments']:.3e} metrics {dk['metrics']:.3e}, plain params "
                f"{pd['params']:.3e} moments {pd['moments']:.3e} metrics "
                f"{pd['metrics']:.3e}; loss "
                f"{float(met_k[0, 4]):.4f} -> {float(met_k[-1, 4]):.4f}")
            if hold_both:
                check(f64_rule(dist, kernel),
                      f"{name} further from f64 than 3x the plain version")
            again = ft.fused_chunk(flat, zeros, zeros, 0.0, data, idx, **kkw)
            same = all(torch.equal(a, b) for a, b in
                       zip(pk + ok + [met_k], again[0] + again[1] + again[2] + [again[3]]))
            log(f"{name} 100 steps run twice: bit-identical {same}")
            check(same, f"{name} differs between two runs of one chunk")
            errs[kernel] = err_p
        if hold_both:
            # the cluster kernel over seeds: a bias its plain version shares
            # shows against float64 only
            kind = "periodic" if periodic else "cube"
            held = sum(hold_f64(f"[fused f64 {kind} B={B} seed {seed}]",
                                fused_drift_runs(em, ft, kind, B, seed, F64_STEPS,
                                                 ("fused_train_cluster",)),
                                F64_STEPS, run="fused_train_cluster")
                       for seed in F64_SEEDS)
            log(f"[fused {tag}] fused_train_cluster held to float64 in {held} of "
                f"{len(F64_SEEDS) * len(F64_STEPS)} readings (seeds {F64_SEEDS}, "
                f"steps {F64_STEPS})")

        p, flat, n_enc, zeros, data, idx = _fused_setup(em, ft, d0, periodic, 500, B=B)
        runs = {k: dict(n_enc=n_enc, hyper=hyper, kernel=k) for k in FUSED_KERNELS}
        ms = {k: [] for k in runs}
        for order in (list(runs), list(runs)[::-1]):  # in turns: a, b, b, a
            for k in order:
                ms[k].append(time_ms(lambda: ft.fused_chunk(flat, zeros, zeros, 0.0,
                                                            data, idx, **runs[k]), 3))
        ms = {k: sum(v) / len(v) for k, v in ms.items()}
        ms_p = time_ms(lambda: ft.fused_chunk_plain(flat, zeros, zeros, 0.0, data,
                                                    idx, n_enc=n_enc, hyper=hyper),
                       1, warmup=0)
        b, cluster_ms = _fused_bound(ft, flat, data, idx, n_enc, d0, periodic,
                                     tuple(hyper["losses"]["dist_sig_parameters"]))
        for k in FUSED_KERNELS:
            log(f"[fused {tag} {k}] 500-step chunk: {ms[k]:.3f} ms "
                f"({1e3 * ms[k] / 500:.2f} us/step), plain {ms_p:.1f} ms, bound "
                f"{b[0]:.4f} ms ({b[1]})")
        log(f"[fused {tag}] the {ft.CLUSTER}-SM cluster's own f32 ceiling: "
            f"{cluster_ms:.4f} ms")
        other = ({"fused_train", "fused_train_cluster"} - {routed}).pop()
        log(f"[fused {tag}] fused_route takes {routed}: {ms[routed]:.3f} ms against "
            f"{ms[other]:.3f} ms")
        check(ms[routed] <= (1 + margin) * ms[other],
              f"fused {tag}: the routed kernel {routed} is slower than {other} "
              f"by more than {margin:.0%}")

        for k, phases, rows in (
                ("fused_train_cluster", ft.CLUSTER_PHASES, ft.CLUSTER),
                ("fused_train", ft.GRID_PHASES,
                 ft.grid_launch_plan(dims, n_enc, B, d0, periodic)["ctas"])):
            log_split(ft, f"fused {tag} {k}", flat, zeros, data, idx, runs[k], ms[k],
                      phases, rows)
        out[tag] = dict(err=errs, ms=ms, ms_p=ms_p, bound=b, cluster_ms=cluster_ms)
    return out


def log_split(ft, tag: str, flat, zeros, data, idx, kw: dict, ms: float, phases,
              rows: int) -> dict:
    """A fused kernel's split of a step by phase: its cycle trace (thread 0
    of each CTA, averaged over the CTAs) scaled to the chunk's measured
    ``ms``; returns microseconds a step by phase."""
    clocks = torch.zeros((rows, len(phases)), dtype=torch.int64, device="cuda")
    ft.fused_chunk(flat, zeros, zeros, 0.0, data, idx, clocks=clocks, **kw)
    torch.cuda.synchronize()
    cyc = clocks.double().mean(0)
    us_step = 1e3 * ms / idx.shape[0]
    split = {name: float(c / cyc.sum()) * us_step for name, c in zip(phases, cyc)}
    log(f"[{tag}] step by phase (us, cycle shares of thread 0 averaged over the "
        f"CTAs, scaled to {us_step:.2f} us): "
        + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    return split


def _grid_setup(em, ft, neurons: list, d0: int, periodic: bool, steps: int, B: int):
    """Weights of widths ``neurons`` from seed 0, the fused route's data
    (the 3-cube's 125,000 points, or uniform dihedrals) and ``(steps, B)``
    batch indices."""
    from encodermap_tpu_torch.models import sequential as seq

    p, _, _, _, data, idx = _fused_setup(em, ft, d0, periodic, steps, B=B)
    p = em.Parameters(n_neurons=neurons, batch_size=B,
                      periodicity=2 * math.pi if periodic else float("inf"))
    params = seq.init_params(torch.Generator().manual_seed(0), p, d0, device="cuda")
    flat, n_enc = ft.split_params(params)
    return p, flat, n_enc, [torch.zeros_like(t) for t in flat], data, idx


#: the grid kernel's timed shapes: (tag, widths, d0, periodic, B, steps a
#: timed chunk, the 100-step float64 rule)
GRID_SHAPES = (
    ("cube B=1024", [128, 128, 2], 3, False, 1024, 50, True),
    ("periodic d0=4 B=1024", [128, 128, 2], 4, True, 1024, 50, True),
    ("cube B=1000 (ragged)", [128, 128, 2], 3, False, 1000, 50, False),
    ("[256,256,2] B=256", [256, 256, 2], 3, False, 256, 50, False),
    ("cube B=4096", [128, 128, 2], 3, False, 4096, 20, False),
    ("cube B=16384", [128, 128, 2], 3, False, 16384, 5, False),
)


def phase_grid(em, ft, _build) -> dict:
    """The grid kernel where the router sends it, at each of GRID_SHAPES:
    the routed launch (counts reset just before, read just after), held to
    its plain version over 1 step (moments 1e-4 of their largest entry) and
    5 steps (parameters 1e-4, moments 1e-3, metrics 1e-4 relative), at
    B=1024 over 100 steps to the float64 rule, bit for bit on a second run;
    then timed (CUDA events, a chunk of the shape's steps, 3 chunks after a
    warm-up) with its bound and its split of a step by phase. The cluster
    kernel holds none of these shapes. Returns, by tag, the launches, the
    error, the times and the bound."""
    out = {}
    for tag, neurons, d0, periodic, B, t_steps, long_rule in GRID_SHAPES:
        name = f"[grid {tag}]"
        p, flat, n_enc, zeros, data, idx = _grid_setup(em, ft, neurons, d0, periodic, 5, B)
        kw = dict(n_enc=n_enc, hyper=ft.hyper_from(p))
        dims = [flat[0].shape[0]] + [w.shape[1] for w in flat[:len(flat) // 2]]
        check(ft.fused_route(dims, n_enc, B, d0) == "fused_train",
              f"{name} the router does not take the grid kernel")
        fits = ft.cluster_footprint(dims, n_enc, B, d0)["total"] <= ft.MAX_SMEM_BYTES
        check(not fits, f"{name} the cluster kernel holds this shape: time both")
        _build.launch_counts.clear()
        pk, mk, vk, met_k = ft.fused_chunk(flat, zeros, zeros, 0.0, data, idx, **kw)
        torch.cuda.synchronize()
        counts = dict(_build.launch_counts)
        check(counts == {"fused_train": 1}, f"{name} launched {counts}")
        pp, mp, vp, met_p = ft.fused_chunk_plain(flat, zeros, zeros, 0.0, data, idx, **kw)
        _, mk1, vk1, _ = ft.fused_chunk(flat, zeros, zeros, 0.0, data, idx[:1], **kw)
        _, mp1, vp1, _ = ft.fused_chunk_plain(flat, zeros, zeros, 0.0, data, idx[:1], **kw)
        m1 = _rel_to_max(mk1 + vk1, mp1 + vp1)
        e5, r5 = _max_err(pk, pp), _rel_err(met_k, met_p)
        m5 = _rel_to_max(mk + vk, mp + vp)
        again = ft.fused_chunk(flat, zeros, zeros, 0.0, data, idx, **kw)
        same = all(torch.equal(a, b) for a, b in zip(pk + mk + vk + [met_k],
                                                      again[0] + again[1] + again[2] + [again[3]]))
        log(f"{name} launches {counts}; 1 step: moments max rel-to-max {m1:.3e}; 5 steps: "
            f"params max abs {e5:.3e}, moments max rel-to-max {m5:.3e}, metrics max rel "
            f"{r5:.3e}; run twice: bit-identical {same}")
        check(m1 <= 1e-4, f"{name} 1-step moments mismatch")
        check(e5 <= 1e-4 and r5 <= 1e-4 and m5 <= 1e-3, f"{name} 5-step mismatch")
        check(same, f"{name} differs between two runs of one chunk")
        launches = counts["fused_train"]
        del pp, mp, vp, again
        if long_rule:
            # as phase_fused: three times the plain f32 version's own
            # distance from a float64 run of it, over 100 steps
            _, _, _, _, _, idx100 = _grid_setup(em, ft, neurons, d0, periodic, 100, B)
            res = fused_f64_runs(ft, flat, zeros, kw, data, idx100, ("fused_train",))[100]
            dist = f64_distances(res)
            (pk, ok, met_k), dk, pd = res["fused_train"], dist["fused_train"], dist["plain f32"]
            again = ft.fused_chunk(flat, zeros, zeros, 0.0, data, idx100, **kw)
            same = all(torch.equal(a, b) for a, b in
                       zip(pk + ok + [met_k], again[0] + again[1] + again[2] + [again[3]]))
            log(f"{name} 100 steps vs f64: kernel params {dk['params']:.3e} moments "
                f"{dk['moments']:.3e} metrics {dk['metrics']:.3e}, plain params "
                f"{pd['params']:.3e} moments {pd['moments']:.3e} metrics "
                f"{pd['metrics']:.3e}; loss {float(met_k[0, 4]):.4f} -> "
                f"{float(met_k[-1, 4]):.4f}; run twice: bit-identical {same}")
            check(bool(torch.isfinite(met_k).all()), f"{name} non-finite metrics")
            check(f64_rule(dist, "fused_train"),
                  f"{name} further from f64 than 3x the plain version")
            check(same, f"{name} 100 steps differ between two runs")
            del res, again

        _, _, _, _, _, idx_t = _grid_setup(em, ft, neurons, d0, periodic, t_steps, B)
        ms = time_ms(lambda: ft.fused_chunk(flat, zeros, zeros, 0.0, data, idx_t, **kw), 3)
        ms_p = time_ms(lambda: ft.fused_chunk_plain(flat, zeros, zeros, 0.0, data, idx_t,
                                                    **kw), 1, warmup=0)
        b, _ = _fused_bound(ft, flat, data, idx_t, n_enc, d0, periodic,
                            tuple(kw["hyper"]["losses"]["dist_sig_parameters"]))
        log(f"{name} grid kernel {t_steps}-step chunk: {ms:.3f} ms "
            f"({1e3 * ms / t_steps:.2f} us/step), plain {ms_p:.2f} ms, bound {b[0]:.4f} ms "
            f"({b[1]}, {1e3 * b[0] / t_steps:.2f} us/step)")
        plan = ft.grid_launch_plan(dims, n_enc, B, d0, periodic)
        split = log_split(ft, f"grid {tag}", flat, zeros, data, idx_t, kw, ms,
                          ft.GRID_PHASES, plan["ctas"])
        log(f"{name} plan: {plan['groups']} row groups of {plan['rows']} rows, "
            f"{plan['ctas']} CTAs, {plan['pair_tiles']} pair tiles, scratch "
            f"{4 * plan['floats']['total'] / 1e6:.1f} MB")
        out[tag] = dict(launches=launches, err=e5, ms=ms, ms_p=ms_p, bound=b,
                        steps=t_steps, split=split)
        torch.cuda.empty_cache()
    return out


def general_step(em, B: int, steps: int = 3) -> dict:
    """The general (autograd) route's step at [128,128,2], cube, batch B:
    a ``fused_trainer=False`` chunk trainer of ``steps`` steps timed by CUDA
    events (2 chunks after a warm-up), and the device's busy time in one
    chunk (torch.profiler)."""
    data = em.create_n_cube(3, points_along_edge=500, seed=0)[0]
    p = em.Parameters(n_neurons=[128, 128, 2], batch_size=B, steps_per_scan=steps,
                      n_steps=steps, seed=0, periodicity=float("inf"),
                      fused_trainer=False)
    emap = em.EncoderMap(p, data, read_only=True)
    trainer, dev_data = emap._get_trainer(), emap._device_data()
    state = emap.state

    def chunk():
        nonlocal state
        state, _ = trainer(state, dev_data)

    ms = time_ms(chunk, 2) / steps
    busy = device_split(chunk, ms, steps, f"general B={B}")
    return dict(ms=ms, busy=busy)


# ------------------------------------------ the general route against float64
#: a float32 run has left the float64 run where its largest parameter
#: difference from it passes this (the part counts of PERF.md)
F64_PART = 1e-4
#: the general route's shapes phase_general_f64 holds to float64 (data, B);
#: the seeds and the step counts it and phase_fused read (periodic data
#: parts the plain float32 run from float64 by step 60, so there step 10 is
#: what is held)
GENERAL_F64_SHAPES = (("cube", 1024), ("periodic", 1024), ("config5", 256))
F64_SEEDS = (0, 1, 2)
F64_STEPS = (10, 100)


def drift_setup(em, kind: str, B: int, seed: int, steps: int) -> tuple:
    """The data of a float64 drift run and a ``(steps, B)`` stream of its
    rows: ``kind`` "cube" or "periodic" is the fused route's data, whose
    seed 0 draws the fused route's batches (``_fused_setup``); "config5" is
    config 5's million 6-feature frames (``phase_streaming``). Every other
    stream comes from ``np.random.default_rng([seed, columns])``. Returns
    ``(data, periodic, idx)`` as numpy."""
    if kind == "config5":
        data, rng = np.random.default_rng(0).standard_normal((STREAM_FRAMES, 6)), None
    else:
        data, rng = _fused_data(em, 4 if kind == "periodic" else 3, kind == "periodic")
    if seed or rng is None:
        rng = np.random.default_rng([seed, data.shape[1]])
    return data, kind == "periodic", rng.integers(0, len(data), (steps, B))


def general_f64_runs(em, kind: str, B: int, seed: int, steps=(10, 60, 100),
                     kernel_runs: int = 1) -> dict:
    """The general route's step at [128,128,2] from the weights of seed 0,
    over the batches ``drift_setup`` draws, four ways: "f64", the step in
    float64 with the sketch-map loss through ``sigmoid_loss_general``;
    "plain f32", the same in float32; "plain f32 rows reversed", that on
    each batch's rows in reverse order (the same function, its sums in
    another order); "kernels", the step of ``EncoderMap(fused_trainer=
    False)`` itself, float32 through the sigmoid-loss kernels on the card.
    ``kernel_runs=2`` adds "kernels again", a second run of it. Returns, for
    each N of ``steps`` and each run, the parameters, the Adam moments and
    the ``(N, 5)`` metrics (the total loss last) after N steps."""
    from encodermap_tpu_torch.ops.fused_sigmoid import sigmoid_loss_general
    from encodermap_tpu_torch.train.core import TrainState, tree_leaves, tree_map

    class PlainSigmoid(em.EncoderMap):
        """The general route's step with its sketch-map loss on the general
        path at any dtype (the kernels take float32)."""

        def _loss_terms(self, params, batch):
            batch, latent, out = self._forward_rows(params, batch)
            terms = self._row_terms(params, batch, latent, out)
            terms["distance_loss"] = self.p.distance_cost_scale * sigmoid_loss_general(
                batch, latent, tuple(self.p.dist_sig_parameters), self.p.periodicity)
            return terms

    data, periodic, idx = drift_setup(em, kind, B, seed, max(steps))
    p = em.Parameters(n_neurons=[128, 128, 2], batch_size=B, seed=0, fused_trainer=False,
                      periodicity=2 * math.pi if periodic else float("inf"))
    kernels = em.EncoderMap(p, data, read_only=True, device="cuda")
    plain = PlainSigmoid(p, data, model_params=kernels.state.params, read_only=True,
                         device="cuda")
    x32, state = kernels._device_data(), kernels.state
    idx = torch.as_tensor(idx, device=x32.device)
    state64 = TrainState.create(tree_map(torch.Tensor.double, state.params),
                                kernels.optimizer, state.rng)
    runs = {"f64": (plain, state64, x32.double(), idx),
            "plain f32": (plain, state, x32, idx),
            "plain f32 rows reversed": (plain, state, x32, idx.flip(1)),
            "kernels": (kernels, state, x32, idx)}
    if kernel_runs == 2:
        runs["kernels again"] = runs["kernels"]
    out = {n: {} for n in steps}
    for name, (model, st, x, ix) in runs.items():
        trainer, rows, start = model._get_trainer(max(steps)), [], 0
        for n in steps:
            st, met = trainer(st, x, idx=ix[start:n])
            keys = sorted(k for k in met if k != "loss") + ["loss"]
            rows.append(torch.stack([met[k] for k in keys], dim=1))
            start = n
            out[n][name] = (tree_leaves(st.params),
                            tree_leaves(st.opt_state["mu"]) + tree_leaves(st.opt_state["nu"]),
                            torch.cat(rows))
    return out


def fused_f64_runs(ft, flat: list, zeros: list, kw: dict, data, idx, kernels=(),
                   steps=None) -> dict:
    """The fused route's chunk from the weights ``flat`` and zero moments
    over the batches ``idx``, the ways ``general_f64_runs`` runs the general
    route's step: "f64", the plain version in float64; "plain f32"; "plain
    f32 rows reversed"; and each of the fused ``kernels`` by its name.
    Returns, for each N of ``steps`` (by default all of idx's) and each
    run, the parameters, the Adam moments and the ``(N, 5)`` metrics after
    N steps, as ``general_f64_runs`` does."""
    f64, z64 = [t.double() for t in flat], [t.double() for t in zeros]
    plain = ft.fused_chunk_plain
    runs = {"f64": (plain, f64, z64, data.double(), idx, {}),
            "plain f32": (plain, flat, zeros, data, idx, {}),
            "plain f32 rows reversed": (plain, flat, zeros, data, idx.flip(1), {}),
            **{k: (ft.fused_chunk, flat, zeros, data, idx, dict(kernel=k)) for k in kernels}}
    steps = steps or (idx.shape[0],)
    out = {n: {} for n in steps}
    for name, (chunk, params, z, x, ix, extra) in runs.items():
        mu, nu, rows, start = z, z, [], 0
        for n in steps:
            params, mu, nu, met = chunk(params, mu, nu, float(start), x, ix[start:n],
                                        **kw, **extra)
            rows.append(met)
            start = n
            out[n][name] = (params, mu + nu, torch.cat(rows))
    return out


def fused_drift_runs(em, ft, kind: str, B: int, seed: int, steps=(10, 60, 100),
                     kernels=None) -> dict:
    """``fused_f64_runs`` from the fused route's weights of seed 0 at
    [128,128,2] over the data and batches ``drift_setup`` draws for
    ``kind`` ("cube", "periodic" or config 5's 6-feature frames,
    "config5"), for each fused kernel of ``kernels``: by default each one
    that can take the shape."""
    data, periodic, idx = drift_setup(em, kind, B, seed, max(steps))
    p, flat, n_enc, zeros = _fused_weights(em, ft, data.shape[1], periodic, B)
    if kernels is None:
        dims = [flat[0].shape[0]] + [w.shape[1] for w in flat[:len(flat) // 2]]
        kernels = [k for k in FUSED_KERNELS if k == "fused_train" or ft.cluster_footprint(
            dims, n_enc, B, data.shape[1])["total"] <= ft.MAX_SMEM_BYTES]
    return fused_f64_runs(ft, flat, zeros, dict(n_enc=n_enc, hyper=ft.hyper_from(p)),
                          torch.as_tensor(data, dtype=torch.float32, device="cuda"),
                          torch.as_tensor(idx, device="cuda"), kernels, steps)


def f64_distances(res: dict) -> dict:
    """Each run's distance from the "f64" run in one entry of
    ``general_f64_runs`` or ``fused_f64_runs``: the largest parameter difference, the largest
    relative metric difference, the largest moment difference relative to
    its tensor's largest entry; and its loss at the last step."""
    p64, o64, m64 = res["f64"]
    return {name: dict(params=_max_err(p, p64), metrics=_rel_err(m, m64),
                       moments=_rel_to_max(o, o64), loss=float(m[-1, -1]))
            for name, (p, o, m) in res.items()}


def f64_rule(dist: dict, run: str = "kernels") -> bool:
    """The float64 rule of every train route: the kernels' run
    (``dist[run]``, distances from float64 as ``f64_distances`` gives them)
    no further from float64 than three times the plain float32 run
    (``dist["plain f32"]``), plus 1e-4 in the parameters and metrics and
    1e-3 in the moments."""
    k, p = dist[run], dist["plain f32"]
    return (k["params"] <= 3 * p["params"] + 1e-4 and k["metrics"] <= 3 * p["metrics"] + 1e-4
            and k["moments"] <= 3 * p["moments"] + 1e-3)


def f64_gate(dist: dict) -> str:
    """Why ``f64_rule`` cannot tell a bias from rounding on these distances
    (``f64_distances``), or "" where it can: where the plain float32 run
    stays within F64_PART of float64 (ROADMAP.md, port rules) and the same
    plain step on reversed rows, which differs from it only in the order of
    its float32 sums, passes the rule itself (on periodic data the Adam
    moments of the two orders can lie 16x apart after 10 steps)."""
    if dist["plain f32"]["params"] > F64_PART:
        return "the plain float32 run left float64"
    if not f64_rule(dist, "plain f32 rows reversed"):
        return "the plain step on reversed rows fails the rule itself"
    return ""


def hold_f64(name: str, res: dict, steps, run: str = "kernels", note: str = "") -> int:
    """``run`` of ``res`` (``general_f64_runs`` or ``fused_f64_runs``) held
    to ``f64_rule`` after each N of ``steps`` where ``f64_gate`` lets the
    rule tell a bias from rounding, else logged. Returns the readings
    held."""
    held = 0
    for n in steps:
        dist = f64_distances(res[n])
        why = f64_gate(dist)
        log(f"{name} {n} steps, float64 loss {dist['f64']['loss']:.5f}; from "
            "float64: " + "; ".join(
                f"{r} params {d['params']:.3e} metrics {d['metrics']:.3e} "
                f"moments {d['moments']:.3e} (loss {d['loss']:.5f})"
                for r, d in dist.items() if r not in ("f64", "kernels again"))
            + f"; {note}" + (f"not held: {why}" if why else "held to the rule"))
        check(all(math.isfinite(d["loss"]) for d in dist.values()),
              f"{name} non-finite loss after {n} steps")
        if not why:
            check(f64_rule(dist, run),
                  f"{name} further from f64 than 3x the plain version after {n} steps")
            held += 1
    return held


def phase_general_f64(em, _build) -> dict:
    """The general route against float64 at each of GENERAL_F64_SHAPES and
    F64_SEEDS after F64_STEPS (``general_f64_runs``): the kernels' route
    held to ``f64_rule`` by ``hold_f64``'s gate, and bit for bit over two
    runs. Every run, the float64 one too, steps through the clip + Adam
    kernel once a step. Returns the sigmoid and the clip + Adam kernels'
    launches."""
    t0 = time.perf_counter()
    launches = {"sigmoid_fwd": 0, "sigmoid_bwd": 0, "clip_adam": 0}
    n_last = F64_STEPS[-1]
    for kind, B in GENERAL_F64_SHAPES:
        for seed in F64_SEEDS:
            name = f"[general f64 {kind} B={B} seed {seed}]"
            _build.launch_counts.clear()
            res = general_f64_runs(em, kind, B, seed, F64_STEPS, kernel_runs=2)
            torch.cuda.synchronize()
            counts = dict(_build.launch_counts)
            check(counts == {"sigmoid_fwd": 2 * n_last, "sigmoid_bwd": 2 * n_last,
                             "clip_adam": len(res[n_last]) * n_last},
                  f"{name} launched {counts}")
            for k in launches:
                launches[k] += counts[k]
            (pk, ok, mk), (pa, oa, ma) = res[n_last]["kernels"], res[n_last]["kernels again"]
            same = all(torch.equal(a, b) for a, b in zip(pk + ok + [mk], pa + oa + [ma]))
            check(same, f"{name} the kernels' route differs between two runs")
            hold_f64(name, res, F64_STEPS,
                     note=f"kernels run twice: bit-identical {same}; ")
    log(f"[leg] phase_general_f64: {time.perf_counter() - t0:.1f} s wall")
    return launches


def phase_train(em, ft, _build, run_dir: Path, periodic: bool, B: int = 256) -> dict:
    """EncoderMap.train() on the fused route at batch B; returns the launch
    counts of the run, which must be the kernel fused_route picks for the
    shape (the cluster kernel at the default B=256, below GRID_MIN_BATCH;
    the grid kernel at B=1024) and not the other."""
    tag = f"{'periodic 4-dihedral' if periodic else 'cube'} B={B}"
    if periodic:
        data = np.random.default_rng(0).uniform(
            -np.pi, np.pi, (125000, 4)).astype(np.float32)
    else:
        data = em.create_n_cube(3, points_along_edge=500, seed=0)[0]
    p = em.Parameters(main_path=str(run_dir), n_neurons=[128, 128, 2],
                      batch_size=B, steps_per_scan=500, n_steps=2000, seed=0,
                      periodicity=2 * math.pi if periodic else float("inf"))
    emap = em.EncoderMap(p, data)
    d_in = 2 * data.shape[1] if periodic else data.shape[1]
    routed = ft.fused_route([d_in, 128, 128, 2, 128, 128, d_in], 3, B, data.shape[1])
    other = ({"fused_train", "fused_train_cluster"} - {routed}).pop()
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    hist = emap.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.launch_counts)
    check(counts.get(routed, 0) > 0, f"train {tag}: {routed} was not launched")
    check(counts.get(other, 0) == 0, f"train {tag}: {other} ran where {routed} is routed")
    first, last = hist["loss"][:500].mean(), hist["loss"][-500:].mean()
    log(f"[train {tag}] {routed} launches {counts[routed]}, loss first chunk mean "
        f"{first:.4f} -> last {last:.4f}, train() {wall:.2f} s")
    check(last < first, f"train {tag}: loss did not fall")

    latent = emap.encode(data[:4096])
    recon = emap.decode(latent)
    gen = emap.generate(latent[:16])
    check(latent.shape == (4096, 2) and recon.shape == (4096, data.shape[1]),
          f"train {tag}: shapes")
    check(all(np.isfinite(x).all() for x in (latent, recon, gen)),
          f"train {tag}: non-finite encode/decode/generate")
    again = em.EncoderMap.from_checkpoint(run_dir, train_data=data)
    check(np.array_equal(again.encode(data[:4096]), latent),
          f"train {tag}: reloaded checkpoint encodes differently")

    trainer = emap._get_trainer()
    dev_data = emap._device_data()
    state = emap.state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        state, metrics = trainer(state, dev_data)
    float(metrics["loss"][-1])
    dt = time.perf_counter() - t0
    log(f"[train {tag}] checkpoint reload encodes identically; "
        f"{3 * 500 * B / dt:.0f} samples/s over 3 chunks of 500 steps")
    return counts


def phase_general(em, _build, run_dir: Path, sig_ms: float) -> dict:
    """The general (autograd) route at B=16384: the sigmoid-loss kernels.
    ``sig_ms`` is their forward + backward time at this shape (router
    phase), to split the chunk's step time."""
    data = em.create_n_cube(3, points_along_edge=500, seed=0)[0]
    p = em.Parameters(main_path=str(run_dir), n_neurons=[128, 128, 2],
                      batch_size=16384, steps_per_scan=3, n_steps=6, seed=0,
                      periodicity=float("inf"), fused_trainer=False)
    emap = em.EncoderMap(p, data)
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    hist = emap.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.launch_counts)
    check(counts.get("sigmoid_fwd", 0) > 0 and counts.get("sigmoid_bwd", 0) > 0,
          f"general route: sigmoid kernels not launched ({counts})")
    check(counts.get("fused_train", 0) == 0 and counts.get("fused_train_cluster", 0) == 0,
          "general route ran a fused kernel")
    check(counts.get("clip_adam", 0) == p.n_steps,
          f"general route: clip + Adam kernel launched {counts}, expected once a step")
    check(bool(np.isfinite(hist["loss"]).all()), "general route: non-finite loss")
    log(f"[general] launches {counts}, loss {hist['loss'][0]:.4f} -> "
        f"{hist['loss'][-1]:.4f}, {6 * 16384 / wall:.0f} samples/s "
        f"(train() wall clock, 6 steps)")

    trainer, dev_data = emap._get_trainer(), emap._device_data()
    state = emap.state

    def chunk():
        nonlocal state
        state, _ = trainer(state, dev_data)

    ms = time_ms(chunk, 2) / 3
    log(f"[general] chunk trainer alone: {ms:.3f} ms/step (CUDA events, 2 chunks "
        f"of 3 steps), of which sigmoid kernels fwd+bwd {sig_ms:.3f} ms, the rest "
        f"(MLP, autograd, clip + Adam, batch draw) {ms - sig_ms:.3f} ms")
    busy = device_split(chunk, ms, 3, "general")
    return dict(counts, step=dict(ms=ms, busy=busy))


def device_split(chunk, ms_step: float, steps: int, tag: str) -> float:
    """The device's busy time per step over one chunk (torch.profiler's
    CUDA activities), its idle share against ``ms_step``, the device
    operations (kernels and copies) per step, and the kernels that take
    the most of it; returns the busy ms per step (0 if the profiler saw no
    device time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        chunk()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3 / steps
    if busy == 0:
        log(f"[{tag}] device busy time: not measured (the profiler saw no device time)")
        return 0.0
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    ops = sum(e.count for e in events) / steps
    log(f"[{tag}] device busy {busy:.3f} ms/step (torch.profiler, 1 chunk), idle share "
        f"{1 - busy / ms_step:.3f} of {ms_step:.3f} ms, {ops:.0f} device operations a "
        f"step; most device time: " + "; ".join(
            f"{e.key[:60]} {e.self_device_time_total / 1e3 / steps:.3f} ms" for e in top))
    return busy


# ----------------------------------------------------------------- ADC
ADC_SIG = (4.5, 12, 6, 1, 2, 6)  # ADCParameters' default sigmoid parameters
CV_KEYS = ("central_angles", "central_dihedrals", "central_cartesians",
           "central_distances", "side_dihedrals")
SIDECHAIN_KEYS = ("central_angles", "central_dihedrals", "all_cartesians",
                  "central_distances", "side_angles", "side_dihedrals",
                  "side_distances")
#: trp-cage's sequence and its sidechain dihedrals per residue (chi1-chi5 of
#: each residue type): 37 side dihedrals, 54 side atoms, 114 atoms in all
TRP_CAGE = "NLYIQWLKDGGPSSGRPPPS"
TRP_CAGE_SIDECHAIN_INFO = {1: 2, 2: 2, 3: 2, 4: 2, 5: 3, 6: 2, 7: 2, 8: 4, 9: 2,
                           10: 0, 11: 0, 12: 2, 13: 1, 14: 1, 15: 0, 16: 5, 17: 2,
                           18: 2, 19: 2, 20: 1}


#: one-letter to three-letter amino-acid codes
THREE_LETTER = dict(zip("ACDEFGHIKLMNPQRSTVWY", (
    "ALA CYS ASP GLU PHE GLY HIS ILE LYS LEU MET ASN PRO GLN ARG SER THR VAL TRP "
    "TYR").split()))
#: ubiquitin (PDB 1UBQ); M1-linked diubiquitin is this sequence twice
UBIQUITIN = "MQIFVKTLTGKTITLEVEPSDTIENVKAKIQDKEGIPPDQQRLIFAGKQLEDGRTLSDYNIQKESTLHLVLRLRGG"
#: a 20-residue peptide holding every standard amino acid once
ALL_AMINO_ACIDS = "ACDEFGHIKLMNPQRSTVWY"


def side_atom_names(resname: str) -> list:
    """The side-chain atoms that ``CHI_ATOMS`` names for a residue, in chi
    order: the third atom of chi1 (CB), then the last atom of each chi."""
    from encodermap_tpu_torch.data.topology import CHI_ATOMS

    quads = [CHI_ATOMS[f"chi{n}"][resname] for n in range(1, 6)
             if resname in CHI_ATOMS[f"chi{n}"]]
    return [quads[0][2]] + [q[3] for q in quads] if quads else []


def _place(a, b, c, length, angle, torsion):
    """The atom d with |cd| = ``length``, angle b-c-d = ``angle`` and
    dihedral a-b-c-d = ``torsion``, from three placed atoms (the natural
    extension reference frame); every argument batched alike."""
    bc = c - b
    bc = bc / torch.linalg.norm(bc, dim=-1, keepdim=True)
    n = torch.linalg.cross(b - a, bc, dim=-1)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True)
    m = torch.linalg.cross(n, bc, dim=-1)
    return c + length[..., None] * (-torch.cos(angle)[..., None] * bc
                                    + (torch.sin(angle) * torch.cos(torsion))[..., None] * m
                                    + (torch.sin(angle) * torch.sin(torsion))[..., None] * n)


def synthetic_protein(sequence: str, n_frames: int, seed: int = 0,
                      device: str = "cpu") -> tuple:
    """A protein made from a one-letter ``sequence`` and a ``seed``: its
    ``Topology`` and ``(n_frames, n_atoms, 3)`` float32 coordinates in nm.

    Each residue has N, CA, C, O and the side-chain atoms that ``CHI_ATOMS``
    names for it, in chi order (no hydrogens; ALA and GLY have no side
    atoms). The internal coordinates are drawn from ``seed`` around one
    conformation (backbone bonds and angles of an ideal peptide, phi/psi of
    an alpha helix or a beta strand per residue, side chains near trans)
    with Gaussian noise per frame of thermal size, as an MD trajectory near
    one state at 300 K has it: 0.03 A on bonds and 0.07 rad on angles
    (sqrt(kT / 2k) at AMBER-like force constants), 0.3 rad on dihedrals
    and 0.25 rad on side-chain dihedrals. Float64 on ``device``, in Angstrom: the port's
    ``backmap_sidechains_fast`` places N, CA and C and ``guess_amide_O`` the
    carbonyl O. The side chains are placed atom by atom from their three
    predecessors, CB tetrahedrally (C-N-CA-CB -122.5 deg) and each further
    atom at its chi: the fast sidechain backmap puts CB in the backbone
    plane, within 0.1 A of C. Bonds come out near 0.15 nm, so
    ``guess_bonds`` finds the chain and nothing else."""
    from encodermap_tpu_torch.data.topology import Topology
    from encodermap_tpu_torch.ops.backmap import guess_amide_O
    from encodermap_tpu_torch.ops.backmap_sidechains import (backmap_sidechains_fast,
                                                             make_spec)

    names = [THREE_LETTER[c] for c in sequence]
    sides = [side_atom_names(r) for r in names]
    n_res, F = len(names), n_frames
    nb = 3 * n_res
    rng = np.random.default_rng(seed)
    # one conformation: N-CA, CA-C, C-N bonds (A); angles at CA, C, N
    bond = np.tile([1.458, 1.525, 1.329], n_res)[:nb - 1]
    angle = np.tile(np.radians([111.2, 116.2, 121.7]), n_res)[:nb - 2]
    helix = rng.random(n_res) < 0.5
    phi = np.where(helix, -57.0, -120.0) + rng.normal(0, 8, n_res)
    psi = np.where(helix, -47.0, 130.0) + rng.normal(0, 8, n_res)
    omega = 180.0 + rng.normal(0, 3, n_res)
    # central dihedral k turns about bond k+1: psi_i, omega_i, phi_(i+1)
    dih = np.radians(np.stack([psi, omega, np.roll(phi, -1)], 1).reshape(-1)[:nb - 3])
    depth = max(len(x) for x in sides)
    chi = np.radians(180.0 + rng.normal(0, 15, (n_res, depth)))

    def noisy(x, sigma):
        return torch.tensor(x[None] + rng.normal(0, sigma, (F,) + x.shape), device=device)

    zero = torch.zeros((F, 0), dtype=torch.float64, device=device)
    spec = make_spec({i + 1: 0 for i in range(n_res)})
    with torch.no_grad():
        bb = backmap_sidechains_fast(spec, noisy(bond, 0.03), noisy(angle, 0.07),
                                     noisy(dih, 0.3), zero, zero, zero)
        o = guess_amide_O(bb, np.arange(2, nb, 3))
        # side chains, one branch depth at a time over every residue that
        # reaches it: chain[k] = N, CA, CB, CG, ... of each residue
        n_at, ca_at, c_at = (bb[:, k::3] for k in range(3))
        chain = [n_at, ca_at]
        lengths = noisy(np.full((n_res, depth), 1.53), 0.03)
        angles = noisy(np.full((n_res, depth), np.radians(111.5)), 0.07)
        tors = noisy(chi, 0.25)
        tors[:, :, 0] = torch.tensor(np.radians(-122.5), device=device)
        side_pos = []
        for k in range(depth):
            a, b = (c_at, n_at) if k == 0 else (chain[k - 1], chain[k])
            chain.append(_place(a, b, chain[k + 1], lengths[:, :, k], angles[:, :, k],
                                tors[:, :, k]))
            side_pos.append(chain[-1])
    bb, o = bb.cpu().numpy(), o.cpu().numpy()
    side_pos = [x.cpu().numpy() for x in side_pos]

    top = Topology()
    cols = []
    for i, (res, side) in enumerate(zip(names, sides)):
        r = top.add_residue(res, i + 1, 0)
        for j, nm in enumerate(("N", "CA", "C")):
            top.add_atom(nm, nm[0], r)
            cols.append(bb[:, 3 * i + j])
        top.add_atom("O", "O", r)
        cols.append(o[:, i])
        for k, nm in enumerate(side):
            top.add_atom(nm, nm[0], r)
            cols.append(side_pos[k][:, i])
    return top, (np.stack(cols, axis=1) / 10.0).astype(np.float32)


def write_gro(path, top, frame: np.ndarray, box: float = 10.0) -> None:
    """One frame ``(n_atoms, 3)`` nm as a GROMACS .gro file: a title, the
    atom count, one fixed-column line per atom (``%8.3f`` nm) and a cubic
    box of ``box`` nm."""
    lines = ["written by chip_smoke.py", f"{top.n_atoms:5d}"]
    for a in top.atoms:
        x = frame[a.index]
        lines.append(f"{a.residue.resSeq % 100000:5d}{a.residue.name:<5s}{a.name:>5s}"
                     f"{(a.index + 1) % 100000:5d}{x[0]:8.3f}{x[1]:8.3f}{x[2]:8.3f}")
    lines.append(f"{box:10.5f}{box:10.5f}{box:10.5f}")
    Path(path).write_text("\n".join(lines) + "\n")


def adc_cvs(n_res: int, n_frames: int, seed: int = 0) -> dict:
    """Synthetic ADC CVs as bench.py builds them: random bond angles,
    dihedrals, bond lengths and side dihedrals from ``seed`` with numpy,
    and the coordinates backmapped from them (the port's backmap, float64,
    on the card)."""
    from encodermap_tpu_torch.ops.backmap import backmap

    rng = np.random.default_rng(seed)
    n_atoms = 3 * n_res
    ang = rng.uniform(1.6, 2.4, (n_frames, n_atoms - 2))
    dih = rng.uniform(-np.pi, np.pi, (n_frames, n_atoms - 3))
    dist = rng.uniform(0.13, 0.155, (n_frames, n_atoms - 1))
    with torch.no_grad():
        cart = backmap(*(torch.tensor(x, device="cuda") for x in (dist, ang, dih)))
    side = rng.uniform(-np.pi, np.pi, (n_frames, 2 * n_res))
    return {k: np.asarray(v, np.float32) for k, v in zip(
        CV_KEYS, (ang, dih, cart.cpu().numpy(), dist, side))}


def adc_params(em, run_dir: Path, n_steps: int, steps_per_scan: int, **kw):
    """BASELINE config 3 at full width: [128,128,2], B=256, CA costs
    (``cartesian_pwd_start=1, step=3``), angles and sidechains trained, and
    the encoder input's sketch-map cost on (``distance_cost_scale=1``; the
    reference's ADC default leaves it off), so that a step runs both
    sigmoid losses."""
    return em.ADCParameters(main_path=str(run_dir), n_neurons=[128, 128, 2],
                            batch_size=256, n_steps=n_steps,
                            steps_per_scan=steps_per_scan, seed=0,
                            cartesian_pwd_start=1, cartesian_pwd_step=3,
                            use_backbone_angles=True, use_sidechains=True,
                            distance_cost_scale=1.0, **kw)


def adc_kernel_inputs(emap, cvs: dict, rows: np.ndarray) -> dict:
    """The sigmoid kernels' inputs of one ADC batch, by (D, periodicity,
    params): the encoder-input angles, dihedrals and side dihedrals
    (periodic), and the CA pair distances, flat below 64 CAs, else the
    full matrix rows with the sqrt(2) sigma."""
    from encodermap_tpu_torch.models import adc
    from encodermap_tpu_torch.ops.distances import pairwise_dist

    batch = tuple(torch.tensor(cvs[k][rows], device="cuda") for k in CV_KEYS)
    with torch.no_grad():
        latent = adc.encode(emap.state.params, emap.p, batch).contiguous()
        enc_inp = torch.cat([batch[0], batch[1], batch[4]], dim=1)
        ca = batch[2][:, 1::3]
        if ca.shape[1] < 64:
            pairs, params = pairwise_dist(ca, flat=True), ADC_SIG
        else:
            pairs = pairwise_dist(ca).reshape(len(rows), -1).contiguous()
            params = (ADC_SIG[0] * math.sqrt(2.0),) + ADC_SIG[1:]
    return {(enc_inp.shape[1], 2 * math.pi): (enc_inp, latent, ADC_SIG),
            (pairs.shape[1], float("inf")): (pairs, latent, params)}


def adc_kernel_check(fs, inputs: dict, tag: str, reps: int = 5,
                     oracle: bool = False) -> dict:
    """Kernels 2 and 3 against their plain versions at the ADC shapes; the
    plain versions once each (the plain forward at D = 158^2 is ~75k
    launches); ``oracle`` as ``hold_sigmoid`` takes it."""
    out = {}
    for (D, periodicity), (h, l, params) in inputs.items():
        periodic = math.isfinite(periodicity)
        label = f"{tag} sigmoid B={h.shape[0]} D={D} {'periodic' if periodic else 'euclid'}"
        out[D, periodic] = hold_sigmoid(fs, h, l, params, periodicity, label, reps=reps,
                                        plain_reps=1, plain_warmup=0, oracle=oracle)
    return out


def _oracle_hyper(p, n_ca: int) -> dict:
    """``hand_adc_step``'s hyperparameters of an ADC's parameters (CA
    costs: ``cartesian_pwd_start=1, step=3``; a soft start of ``(None,
    None)`` is none)."""
    return dict(
        periodicity=p.periodicity, dihedral_cost_scale=p.dihedral_cost_scale,
        dihedral_cost_reference=p.dihedral_cost_reference,
        angle_cost_scale=p.angle_cost_scale or 0.0,
        angle_cost_reference=p.angle_cost_reference,
        side_dihedral_cost_scale=p.side_dihedral_cost_scale,
        side_dihedral_cost_reference=p.side_dihedral_cost_reference,
        cartesian_cost_scale=p.cartesian_cost_scale,
        cartesian_cost_reference=p.cartesian_cost_reference,
        soft_start=(None if None in tuple(p.cartesian_cost_scale_soft_start)
                    else tuple(p.cartesian_cost_scale_soft_start)),
        cartesian_distance_cost_scale=p.cartesian_distance_cost_scale,
        cartesian_dist_sig_parameters=p.cartesian_dist_sig_parameters,
        distance_cost_scale=p.distance_cost_scale, dist_sig_parameters=p.dist_sig_parameters,
        center_cost_scale=p.center_cost_scale, l2_reg_constant=p.l2_reg_constant,
        ca_start=1, ca_step=3, pair_iu=np.triu_indices(n_ca, k=1))


def _rel_err_to(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float((x.double() - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


def adc_oracle_check(emap, batch: tuple, step: int, tag: str) -> dict:
    """The float64 oracle (``ops/adc_adjoint.py::hand_adc_step``) against
    the ADC step on the card at ``emap``'s weights: the parameter
    gradients of (a) the step in float32 with the sigmoid-loss kernels and
    (b) the same step with their plain versions, each against (c) the
    oracle in float64 on the card; ``err(a, c) <= 3 err(b, c)`` for every
    parameter tensor. Then the latent gradient of the two sigmoid costs
    alone, kernels and plain against ``_sigmoid_loss_and_latgrad``. The
    batch is ``(angles, dihedrals, cartesians, distances, side)`` on the
    card."""
    from encodermap_tpu_torch import losses as L
    from encodermap_tpu_torch.models import adc
    from encodermap_tpu_torch.ops import adc_adjoint
    from encodermap_tpu_torch.ops.distances import pairwise_dist
    from encodermap_tpu_torch.ops.fused_sigmoid import sigmoid_loss_general
    from encodermap_tpu_torch.train.core import tree_leaves, tree_unflatten

    p = emap.p
    route = L.fused_or_reference

    def plain(h, l, params, periodicity, **_):
        return sigmoid_loss_general(h, l, params, periodicity)

    def port(kernels: bool) -> tuple:
        L.fused_or_reference = route if kernels else plain
        try:
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in tree_leaves(emap.state.params)]
            terms = emap._loss_terms(tree_unflatten(emap.state.params, leaves), batch, step)
            loss = sum(v for k, v in terms.items() if k not in emap._metrics_only)
            return torch.autograd.grad(loss, leaves), float(loss.detach())
        finally:
            L.fused_or_reference = route

    (g_a, loss_a), (g_b, loss_b) = port(True), port(False)
    params = emap.state.params
    f64 = [[l[n].double() for l in params[part]] for part in ("encoder", "decoder")
           for n in ("kernel", "bias")]
    ang, dih, cart, dist, side = (x.double() for x in batch)
    gew, geb, gdw, gdb, metrics = adc_adjoint.hand_adc_step(
        f64[0], f64[1], f64[2], f64[3], ang, dih, cart[:, 1::3], dist, side, float(step),
        hyper=_oracle_hyper(p, cart[:, 1::3].shape[1]))
    g_c = tree_leaves({part: [{"bias": b, "kernel": w} for w, b in zip(ws, bs)]
                       for part, ws, bs in (("encoder", gew, geb), ("decoder", gdw, gdb))})
    errs = [(_rel_err_to(a, c), _rel_err_to(b, c)) for a, b, c in zip(g_a, g_b, g_c)]
    loss_rel = abs(loss_a - float(metrics["loss"])) / abs(float(metrics["loss"]))
    log(f"[{tag} oracle] parameter gradients of the step against hand_adc_step in float64 "
        f"(max |x - f64| / max |f64| per tensor, kernels / plain float32): "
        + ", ".join(f"{a:.2e}/{b:.2e}" for a, b in errs)
        + f"; loss {loss_a:.6f} (kernels), {loss_b:.6f} (plain), {float(metrics['loss']):.6f} "
        f"(float64), {loss_rel:.2e} relative")
    check(all(a <= 3 * b for a, b in errs), f"{tag} oracle: the kernels' step parts from "
          f"float64 more than 3x the plain version's: {errs}")
    check(loss_rel <= 1e-4, f"{tag} oracle: loss {loss_a} against float64 {metrics['loss']}")

    with torch.no_grad():
        latent = adc.encode(params, p, batch).contiguous()
    pairs = pairwise_dist(batch[2][:, 1::3], flat=True)
    enc_inp = torch.cat([batch[0], batch[1], batch[4]], dim=1)

    def lat_grad(kernels: bool) -> torch.Tensor:
        L.fused_or_reference = route if kernels else plain
        try:
            lat = latent.clone().requires_grad_(True)
            cost = L.cartesian_distance_loss(pairs, lat, p) + L.distance_loss(enc_inp, lat, p)
            return torch.autograd.grad(cost, lat)[0]
        finally:
            L.fused_or_reference = route

    lat64 = latent.double()
    _, g1 = adc_adjoint._sigmoid_loss_and_latgrad(
        pairs.double(), lat64, p.cartesian_dist_sig_parameters, p.cartesian_distance_cost_scale)
    _, g2 = adc_adjoint._sigmoid_loss_and_latgrad(
        enc_inp.double(), lat64, p.dist_sig_parameters, p.distance_cost_scale,
        periodicity=p.periodicity)
    lat_k, lat_p = (_rel_err_to(lat_grad(k), g1 + g2) for k in (True, False))
    log(f"[{tag} oracle] latent gradient of the two sigmoid costs against "
        f"_sigmoid_loss_and_latgrad in float64: kernels {lat_k:.2e}, plain float32 {lat_p:.2e} "
        f"(relative to its largest entry)")
    check(lat_k <= 3 * lat_p, f"{tag} oracle: latent gradient {lat_k} against plain {lat_p}")
    return dict(errs=errs, lat=(lat_k, lat_p), loss_rel=loss_rel)


def one_way_bytes(B: int, n: int, itemsize: int = 4) -> tuple[int, int]:
    """Bytes the one-way function reads and writes at least, forward and
    backward: dihedrals and coordinates in, coordinates out; dihedrals,
    coordinates and the output's cotangent in, both cotangents out. What
    the kernels keep between the two (``C_0..C_{n-1}``) is the design's
    choice, not the function's, and is left out."""
    atoms = 3 * (n + 3)
    return B * (n + 2 * atoms) * itemsize, B * (2 * n + 3 * atoms) * itemsize


def hold_one_way(B: int = 256, ns: tuple = (28, 29, 112, 113, 236),
                 reps: int = 200) -> dict:
    """The backmap's one-way kernels (``csrc/backmap_one_way.cu``) against
    their plain versions on the same card tensors, float32, at B=256 and n
    = 28, 29 (trp-cage's two halves, the ADC step's shapes), 112, 113
    (a ubiquitin chain's two halves, the multimer diubiquitin step's
    shapes) and 236 (eight 32-bond tiles, every carry). Up to 32 bonds, where the kernels'
    warp scan associates as the plain version's doubling rounds, the output
    and both cotangents agree to 1e-5 of each tensor's largest entry. At
    every n the port's rule for kernels holds: err(kernels, f64) <= 3
    err(plain f32, f64), largest absolute error per tensor, against the
    plain version in float64 on the card (past 32 bonds the scans and the
    suffix sums associate otherwise, and both float32 sides drift from
    float64 along the chain). Two launches give the same bits. Times
    each kernel and the plain version's forward and backward on the card
    alone (``scripts/sigmoid_time.py::device_ms``: a CUDA graph of many
    calls, so the host's time between launches does not count), and
    forward and backward with the host (``time_ms``); the bound is
    ``one_way_bytes`` at 3.35 TB/s (the FLOPs, a few hundred a bond, take
    less). Returns, by n, the forward's and the backward's (abs err, ms,
    plain ms, bound)."""
    from encodermap_tpu_torch.ops.backmap import (
        _one_way_bwd,
        _one_way_bwd_plain,
        _one_way_fwd,
        _one_way_fwd_plain,
        chain_in_plane,
    )

    sys.path.insert(0, str(ROOT / "scripts"))
    from sigmoid_time import device_ms

    out = {}
    for n in ns:
        rng = np.random.default_rng(n)
        chain = chain_in_plane(torch.tensor(rng.uniform(0.13, 0.155, (B, n + 2))),
                               torch.tensor(rng.uniform(1.6, 2.4, (B, n + 1))))
        chain = chain + torch.tensor(rng.normal(0, 0.01, (B, n + 3, 3)))
        dih = torch.tensor(rng.uniform(-np.pi, np.pi, (B, n)))
        g = torch.tensor(rng.normal(size=(B, n + 3, 3)))
        dih, chain, g = (t.to("cuda", torch.float32) for t in (dih, chain, g))

        def kernels():
            y, saved = _one_way_fwd(dih, chain)
            return [y, *_one_way_bwd(saved, g)]

        def plain():
            y, saved = _one_way_fwd_plain(dih, chain)
            return [y, *_one_way_bwd_plain(saved, g)]

        got, again, want = kernels(), kernels(), plain()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        abs_err = [float((a - b).abs().max()) for a, b in zip(got, want)]
        rel = [e / float(b.abs().max()) for e, b in zip(abs_err, want)]
        y64, saved64 = _one_way_fwd_plain(dih.double(), chain.double())
        want64 = [y64, *_one_way_bwd_plain(saved64, g.double())]
        f64 = [(float((a.double() - c).abs().max()), float((b.double() - c).abs().max()))
               for a, b, c in zip(got, want, want64)]
        _, saved_k = _one_way_fwd(dih, chain)
        _, saved_p = _one_way_fwd_plain(dih, chain)
        ms = (device_ms(torch, lambda: _one_way_fwd(dih, chain), reps),
              device_ms(torch, lambda: _one_way_bwd(saved_k, g), reps))
        ms_p = (device_ms(torch, lambda: _one_way_fwd_plain(dih, chain), 20),
                device_ms(torch, lambda: _one_way_bwd_plain(saved_p, g), 20))
        host = time_ms(kernels, reps), time_ms(plain, 20)
        bound = [(1e3 * b / PEAK_BYTES_PER_S, "bytes") for b in one_way_bytes(B, n)]
        label = f"one-way B={B} n={n}"
        log(f"[{label}] kernels against plain float32 (max abs, rel to max): output "
            f"{abs_err[0]:.2e} ({rel[0]:.2e}), dihedral cotangent {abs_err[1]:.2e} "
            f"({rel[1]:.2e}), coordinate cotangent {abs_err[2]:.2e} ({rel[2]:.2e}); two "
            f"launches bit-identical {same} | card alone: fwd {1e3 * ms[0]:.2f} us, bwd "
            f"{1e3 * ms[1]:.2f} us (plain {1e3 * ms_p[0]:.1f} / {1e3 * ms_p[1]:.1f} us; bound "
            f"{1e3 * bound[0][0]:.3f} / {1e3 * bound[1][0]:.3f} us, bytes); fwd + bwd with "
            f"the host {1e3 * host[0]:.1f} us (plain {1e3 * host[1]:.1f} us)")
        log(f"[{label}] from the plain version in float64 (max abs, kernels / plain float32): "
            + ", ".join(f"{k:.2e} / {q:.2e}" for k, q in f64))
        if n <= 32:
            check(max(rel) <= 1e-5, f"{label}: the kernels part from the plain version by {rel}")
        check(all(k <= 3 * q for k, q in f64),
              f"{label}: the kernels part from float64 more than 3x the plain version: {f64}")
        check(same, f"{label}: two launches differ")
        out[n] = dict(fwd=(abs_err[0], ms[0], ms_p[0], bound[0]),
                      bwd=(max(abs_err[1:]), ms[1], ms_p[1], bound[1]), host=host)
    return out


def sidechain_bytes(spec, B: int, itemsize: int = 4) -> tuple[int, int]:
    """Bytes the sidechain backmap reads and writes at least, forward and
    backward: the six inputs in, the coordinates out; the coordinates'
    cotangent and the inputs in, their gradients out. What the kernels keep
    between the two (each bond's rotation and heading) is the design's
    choice, not the function's, and is left out."""
    nb, ns = 3 * spec.n_residues, spec.n_sidechain_atoms
    n_br = int(np.count_nonzero(spec.side_atoms_per_res))
    inputs = (nb - 1) + (nb - 2) + (nb - 3) + ns + ns + (ns - n_br)
    coords = 3 * spec.n_atoms
    return B * (inputs + coords) * itemsize, B * (coords + 2 * inputs) * itemsize


def hold_sidechain(B: int = 256, reps: int = 200) -> dict:
    """The sidechain backmap's kernels (``csrc/backmap_sidechains.cu``) at
    trp-cage (114 atoms, 17 branches), B=256, float32, decoded angles of
    either sign: the coordinates and the gradients of all six inputs held
    to the port's rule for kernels, err(kernels, f64) <= 3 err(plain f32,
    f64) + 1e-6 of the largest entry (``tests/test_torch_cuda.py::
    test_sidechain_backmap_on_card_matches_cpu``'s), against the plain
    version in float64 on the card; two launches give the same bits. Times
    each kernel on the card alone (a CUDA graph of ``reps`` calls), the
    plain version's forward and its autograd backward on the card alone
    (``device_split`` over 20 calls: a CUDA graph would not capture
    autograd), and forward and backward with the host (``time_ms``) both
    ways; the bound is ``sidechain_bytes`` at 3.35 TB/s.
    Returns the forward's and the backward's (abs err, ms, plain ms,
    bound) and the host times."""
    from encodermap_tpu_torch.ops.backmap_sidechains import (
        _backmap_sidechains_fast_plain,
        _sidechain_bwd,
        _sidechain_fwd,
        make_spec,
    )

    sys.path.insert(0, str(ROOT / "scripts"))
    from sigmoid_time import device_ms

    spec = make_spec(TRP_CAGE_SIDECHAIN_INFO)
    rng = np.random.default_rng(23)
    nb, ns = 3 * spec.n_residues, spec.n_sidechain_atoms
    x64 = [torch.tensor(v, device="cuda") for v in (
        rng.uniform(0.13, 0.155, (B, nb - 1)), rng.uniform(-np.pi, np.pi, (B, nb - 2)),
        rng.uniform(-np.pi, np.pi, (B, nb - 3)), rng.uniform(0.13, 0.16, (B, ns)),
        rng.uniform(-np.pi, np.pi, (B, ns)),
        rng.uniform(-np.pi, np.pi, (B, sum(TRP_CAGE_SIDECHAIN_INFO.values()))))]
    g64 = torch.tensor(rng.normal(size=(B, spec.n_atoms, 3)), device="cuda")
    x, g = [t.float() for t in x64], g64.float()

    def kernels():
        out, quat, head = _sidechain_fwd(spec, x)
        return [out, *_sidechain_bwd(spec, x, quat, head, g)]

    def plain(inputs, cot):
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        out = _backmap_sidechains_fast_plain(spec, *leaves)
        return [out.detach(), *torch.autograd.grad(out, leaves, cot)]

    got, again, want, want64 = kernels(), kernels(), plain(x, g), plain(x64, g64)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    f64 = [(float((a.double() - c).abs().max()), float((b.double() - c).abs().max()),
            float(c.abs().max())) for a, b, c in zip(got, want, want64)]
    _, quat, head = _sidechain_fwd(spec, x)
    ms = (device_ms(torch, lambda: _sidechain_fwd(spec, x), reps),
          device_ms(torch, lambda: _sidechain_bwd(spec, x, quat, head, g), reps))
    leaves = [t.clone().requires_grad_(True) for t in x]
    out = _backmap_sidechains_fast_plain(spec, *leaves)
    label = f"sidechain B={B}"
    ms_p = tuple(device_split(lambda: [fn() for _ in range(20)], time_ms(fn, 20), 20,
                              f"{label} plain {way}")
                 for way, fn in (("fwd", lambda: _backmap_sidechains_fast_plain(spec, *x)),
                                 ("bwd", lambda: torch.autograd.grad(out, leaves, g,
                                                                     retain_graph=True))))
    host = time_ms(kernels, reps), time_ms(lambda: plain(x, g), 20)
    bound = [(1e3 * b / PEAK_BYTES_PER_S, "bytes") for b in sidechain_bytes(spec, B)]
    log(f"[{label}] kernels / plain float32 from the plain version in float64 (max abs; "
        f"largest entry): coordinates and the six gradients "
        + ", ".join(f"{k:.2e} / {q:.2e} ({m:.2e})" for k, q, m in f64)
        + f"; two launches bit-identical {same} | card alone: fwd {1e3 * ms[0]:.2f} us, bwd "
        f"{1e3 * ms[1]:.2f} us (plain {1e3 * ms_p[0]:.1f} / {1e3 * ms_p[1]:.1f} us; bound "
        f"{1e3 * bound[0][0]:.3f} / {1e3 * bound[1][0]:.3f} us, bytes); fwd + bwd with the "
        f"host {1e3 * host[0]:.1f} us (plain {1e3 * host[1]:.1f} us)")
    check(all(k <= 3 * q + 1e-6 * m for k, q, m in f64),
          f"{label}: the kernels part from float64 more than 3x the plain version: {f64}")
    check(same, f"{label}: two launches differ")
    return dict(fwd=(f64[0][0], ms[0], ms_p[0], bound[0]),
                bwd=(max(e[0] for e in f64[1:]), ms[1], ms_p[1], bound[1]), host=host)


#: input widths of the benchmark's two ADC configurations at [128,128,2]:
#: trp-cage's backbone (``adc-128-128-2``) and with its sidechains
#: (``adc-sidechains-128-128-2``)
ADC_WIDTHS = {"adc-128-128-2": 304, "adc-sidechains-128-128-2": 412}


def adc_leaf_shapes(width: int) -> list:
    """The 12 leaves of an ADC at [128,128,2] with a ``width``-wide input,
    each layer's bias and kernel."""
    layers = [(2, 128), (128, 128), (128, width), (width, 128), (128, 128), (128, 2)]
    return [s for k in layers for s in ((k[1],), k)]


def hold_clip_adam(reps: int = 500, steps: tuple = (1, 2, 3, 7, 1000)) -> dict:
    """The clip + Adam kernel (``csrc/clip_adam.cu``) against its plain
    version, ``_adam_update`` a leaf, on the same card tensors at the 12
    float32 leaves of each of ADC_WIDTHS' configurations, gradients of
    scale 1.5 (many past the clip): new parameters and both moments bit for
    bit at each of ``steps``. Times, at step 3 on the card alone (a CUDA
    graph, ``device_ms``), the kernel, the plain version (180 launches) and
    the library's multi-tensor Adam (``torch._fused_adam_``, in place,
    after an in-place clamp of the gradients: the same algorithm, its own
    order of operations); the bound is 28 bytes a parameter (p, m, v and g
    read, p, m and v written) at 3.35 TB/s. Returns, by configuration,
    (abs err, ms, plain ms, library ms, bound)."""
    from encodermap_tpu_torch.ops.clip_adam import _adam_update, clip_adam

    sys.path.insert(0, str(ROOT / "scripts"))
    from sigmoid_time import device_ms

    out = {}
    for name, width in ADC_WIDTHS.items():
        g = torch.Generator(device="cuda").manual_seed(width)
        p, m, v, grads = ([torch.randn(s, generator=g, device="cuda") * scale
                           for s in adc_leaf_shapes(width)] for scale in (1.0, 0.1, 0.1, 1.5))
        v = [x.abs() for x in v]

        def kernel(t=3.0):
            return clip_adam(p, m, v, grads, t, 1e-3)

        def plain(t=3.0):
            outs = [_adam_update(*x, t, 1e-3) for x in zip(p, m, v, grads)]
            return [[o[k] for o in outs] for k in range(3)]

        lib = [[x.clone() for x in xs] for xs in (p, m, v, grads)]
        lib_steps = [torch.tensor(3.0, device="cuda") for _ in p]

        def library():
            torch._foreach_clamp_min_(lib[3], -1.0)
            torch._foreach_clamp_max_(lib[3], 1.0)
            torch._fused_adam_(lib[0], lib[3], lib[1], lib[2], [], lib_steps, lr=1e-3,
                               beta1=0.9, beta2=0.999, weight_decay=0.0, eps=1e-7,
                               amsgrad=False, maximize=False)

        err = max(float((a - b).abs().max()) for t in steps
                  for x, y in zip(kernel(float(t)), plain(float(t))) for a, b in zip(x, y))
        n = sum(x.numel() for x in p)
        ms = device_ms(torch, kernel, reps)
        ms_p = device_ms(torch, plain, 50)
        ms_l = device_ms(torch, library, reps)
        bound = (1e3 * 28 * n / PEAK_BYTES_PER_S, "bytes")
        log(f"[clip + Adam {name}] {n} parameters in 12 leaves; kernel against the plain "
            f"version at steps {list(steps)}: max abs {err:.1e} | card alone: kernel "
            f"{1e3 * ms:.3f} us, plain {1e3 * ms_p:.1f} us, torch._fused_adam_ after a "
            f"clamp {1e3 * ms_l:.3f} us; bound {1e3 * bound[0]:.3f} us, bytes")
        check(err == 0, f"clip + Adam {name}: the kernel parts from _adam_update by {err}")
        out[name] = (err, ms, ms_p, ms_l, bound)
    return out


def adc_train(em, _build, cvs: dict, p, tag: str, per_step: int, one_way: int = 2,
              sidechain: int = 0) -> tuple:
    """``train()`` with the launch counts set to 0 just before and read just
    after: the sigmoid kernels must launch ``per_step`` times a step each,
    the one-way kernels ``one_way`` times a step each (a chain's two
    halves, for each protein of a multimer; none where the sidechain
    backmap builds the chain), the sidechain kernels ``sidechain`` times a
    step each, the clip + Adam kernel once a step, the fused train kernels
    never. Returns (emap, history, counts, s)."""
    emap = em.AngleDihedralCartesianEncoderMap(cvs, p)
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    hist = emap.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.launch_counts)
    want = per_step * p.n_steps
    check(counts.get("sigmoid_fwd", 0) == want and counts.get("sigmoid_bwd", 0) == want,
          f"{tag}: sigmoid kernels launched {counts}, expected {want} each")
    want = one_way * p.n_steps
    check(counts.get("one_way_fwd", 0) == want and counts.get("one_way_bwd", 0) == want,
          f"{tag}: one-way kernels launched {counts}, expected {want} each")
    want = sidechain * p.n_steps
    check(counts.get("sidechain_fwd", 0) == want and counts.get("sidechain_bwd", 0) == want,
          f"{tag}: sidechain kernels launched {counts}, expected {want} each")
    check(counts.get("clip_adam", 0) == p.n_steps,
          f"{tag}: clip + Adam kernel launched {counts}, expected {p.n_steps}")
    check(counts.get("fused_train", 0) == 0 and counts.get("fused_train_cluster", 0) == 0,
          f"{tag}: a fused train kernel ran")
    check(bool(np.isfinite(hist["loss"]).all()), f"{tag}: non-finite loss")
    log(f"[{tag}] launches {counts} in {p.n_steps} steps; loss {hist['loss'][0]:.4f} -> "
        f"{hist['loss'][-1]:.4f}; train() {wall:.2f} s, {p.n_steps * p.batch_size / wall:.0f} "
        f"samples/s")
    return emap, hist, counts, wall


def phase_adc(em, fs, _build, run_dir: Path) -> dict:
    """The ADC trainer at trp-cage scale (BASELINE config 3): 20 residues,
    4096 frames, three chunks of 100 steps, the Cartesian cost soft-started
    over steps 0-50. Checks the kernels' launches, the loss, the soft start,
    generate's bond lengths and a checkpoint round trip; times the step and
    its stages; holds the kernels at this leg's shapes, and the step's
    gradients against the float64 oracle (``adc_oracle_check``)."""
    from encodermap_tpu_torch import losses as L
    from encodermap_tpu_torch.ops.backmap import backmap
    from encodermap_tpu_torch.ops.distances import pairwise_dist

    cvs = adc_cvs(20, 4096)
    p = adc_params(em, run_dir, 300, 100, cartesian_cost_scale_soft_start=(0, 50))
    emap, hist, counts, wall = adc_train(em, _build, cvs, p, "adc", 2)
    scale = hist["cartesian_cost_scale"]
    check(np.allclose(scale, np.clip(np.arange(300) / 50, 0, 1), atol=1e-6),
          "adc: the soft-start scale is not in the history as (0, 50) sets it")
    chunks = hist["loss"].reshape(3, 100).mean(1)
    dih = hist["dihedral_loss"].reshape(3, 100).mean(1)
    log(f"[adc] chunk mean loss {chunks.round(4).tolist()}, dihedral loss "
        f"{dih.round(4).tolist()}; soft-start scale {scale[0]:.2f} -> {scale[-1]:.2f}")
    check(chunks[2] < chunks[1] and dih[2] < dih[0], "adc: the loss did not fall")

    latent = emap.encode()
    xyz = emap.generate(latent[:64])
    bonds = np.linalg.norm(np.diff(xyz, axis=1), axis=-1)
    bond_err = float(np.abs(bonds - cvs["central_distances"].mean(0)).max())
    log(f"[adc] generate {xyz.shape}, bond lengths within {bond_err:.2e} nm of the "
        f"training set's means")
    check(xyz.shape == (64, 60, 3) and np.isfinite(xyz).all(), "adc: generate shape")
    check(bond_err <= 1e-4, "adc: generated bond lengths off the training means")
    again = em.AngleDihedralCartesianEncoderMap.from_checkpoint(cvs, run_dir)
    check(np.array_equal(again.encode(), latent), "adc: reloaded checkpoint encodes "
          "differently")
    log("[adc] checkpoint reload encodes identically")

    trainer, dev_data, state = emap._get_trainer(), emap._device_data(), emap.state

    def chunk():
        nonlocal state
        state, _ = trainer(state, dev_data)

    ms = time_ms(chunk, 2, warmup=1) / 100
    busy = device_split(chunk, ms, 100, "adc")
    log(f"[adc] chunk trainer alone: {ms:.3f} ms/step (CUDA events, 2 chunks of 100 "
        f"steps), {256 / ms * 1e3:.0f} samples/s")

    rows = np.random.default_rng(1).integers(0, 4096, 256)
    inputs = adc_kernel_inputs(emap, cvs, rows)
    kern = adc_kernel_check(fs, inputs, "adc", reps=20)
    one_way = hold_one_way()
    clip_adam = hold_clip_adam()
    b = [torch.tensor(cvs[k][rows], device="cuda") for k in CV_KEYS]
    oracle = adc_oracle_check(emap, tuple(b), emap.state.step, "adc")
    ang = b[0].clone().requires_grad_(True)
    dh = b[1].clone().requires_grad_(True)
    out = backmap(b[3], ang, dh)
    g = torch.randn_like(out)
    ms_bf = time_ms(lambda: backmap(b[3], ang, dh), 20)
    ms_bb = time_ms(lambda: torch.autograd.grad(out, (ang, dh), g, retain_graph=True), 20)
    inp_sel = b[2][:, 1::3]
    out_sel = out.detach()[:, 1::3].clone().requires_grad_(True)

    def dense_cost():
        cost = L.cartesian_loss_matrix(pairwise_dist(inp_sel), pairwise_dist(out_sel), emap.p)
        torch.autograd.grad(cost, out_sel)

    ms_dense = time_ms(dense_cost, 20)
    sig = {D: v["fwd"][1] + v["bwd"][1] for (D, _), v in kern.items()}
    log(f"[adc] stages at B=256 (CUDA events): backmap fwd {ms_bf:.4f} ms, bwd {ms_bb:.4f} "
        f"ms; dense Cartesian cost fwd+bwd {ms_dense:.4f} ms; sigmoid kernels fwd+bwd "
        + ", ".join(f"D={D} {t:.4f} ms" for D, t in sig.items())
        + f"; step {ms:.3f} ms, device busy {busy:.3f} ms")
    return dict(counts=counts, kernels=kern, ms=ms, wall=wall, oracle=oracle,
                one_way=one_way, clip_adam=clip_adam)


def phase_adc_matrix(em, fs, _build, run_dir: Path) -> dict:
    """158 residues (lysozyme scale), B=256, 10 steps: 158 CAs take the
    matrix form, so the kernels get CA distance-matrix rows of width
    158^2 = 24,964 with the sqrt(2) sigma; held against their plain
    versions there once."""
    cvs = adc_cvs(158, 1024, seed=1)
    emap, _, counts, _ = adc_train(em, _build, cvs, adc_params(em, run_dir, 10, 10),
                                   "adc 158", 2)
    inputs = adc_kernel_inputs(emap, cvs, np.arange(256))
    check((158 ** 2, float("inf")) in inputs, "adc 158: the matrix rows are not 158^2 wide")
    kern = adc_kernel_check(fs, inputs, "adc 158")
    return dict(counts=counts, kernels=kern)


def phase_adc_analytic(em, fs, _build, run_dir: Path) -> dict:
    """512 residues, B=256, 5 steps: 512 CAs (>= MIN_ANALYTIC_ATOMS) take
    the analytic Cartesian costs (the CA sigmoid from one Gram, no kernel),
    so the kernels run once a step, on the 4,091-wide encoder input. Times
    the dense and the analytic Cartesian costs there once."""
    from encodermap_tpu_torch import losses as L
    from encodermap_tpu_torch.ops.distances import pairwise_dist

    calls = {"analytic": 0}
    analytic = L.cartesian_losses_analytic

    def counted(*args, **kwargs):
        calls["analytic"] += 1
        return analytic(*args, **kwargs)

    cvs = adc_cvs(512, 512, seed=2)
    L.cartesian_losses_analytic = counted
    try:
        emap, _, counts, _ = adc_train(em, _build, cvs, adc_params(em, run_dir, 5, 5),
                                       "adc 512", 1)
    finally:
        L.cartesian_losses_analytic = analytic
    check(calls["analytic"] == 5, f"adc 512: the analytic route ran {calls} times, not 5")
    log(f"[adc 512] analytic route taken on each of the 5 steps (512 selected atoms)")

    rows = np.arange(256)
    inp_sel = torch.tensor(cvs["central_cartesians"][rows, 1::3], device="cuda")
    out_sel = (inp_sel + 0.05 * torch.randn_like(inp_sel)).requires_grad_(True)
    lat = torch.randn((256, 2), device="cuda", requires_grad=True)

    def dense():
        mat = pairwise_dist(inp_sel)
        cost = (L.cartesian_loss_matrix(mat, pairwise_dist(out_sel), emap.p)
                + L.cartesian_distance_loss_matrix(mat, lat, emap.p))
        torch.autograd.grad(cost, (out_sel, lat))

    def analytic_cost():
        cart, cdist = L.cartesian_losses_analytic(inp_sel, out_sel, lat, emap.p)
        torch.autograd.grad(cart + cdist, (out_sel, lat))

    ms_d = time_ms(dense, 2)
    ms_a = time_ms(analytic_cost, 2)
    log(f"[adc 512] Cartesian costs fwd+bwd at B=256, 512 CAs (CUDA events): dense "
        f"{ms_d:.3f} ms (its CA sigmoid on the kernels at D=262,144), analytic {ms_a:.3f} ms")
    kern = adc_kernel_check(fs, {k: v for k, v in adc_kernel_inputs(emap, cvs, rows).items()
                                 if math.isfinite(k[1])}, "adc 512")
    return dict(counts=counts, kernels=kern, ms_dense=ms_d, ms_analytic=ms_a)


def sidechain_cvs(n_frames: int, seed: int = 0, device: str = "cuda") -> dict:
    """Synthetic trp-cage CVs with sidechains: random internals from
    ``seed`` with numpy, in the ranges of
    ``tests/test_sidechain_reconstruction.py``, and every atom backmapped
    from them by the port's fast sidechain backmap in float64 on
    ``device``; ``central_cartesians`` are the first 60 atoms (the
    backbone), which ``train_for_references`` reads."""
    from encodermap_tpu_torch.ops.backmap_sidechains import backmap_sidechains_fast, make_spec

    spec = make_spec(TRP_CAGE_SIDECHAIN_INFO)
    rng = np.random.default_rng(seed)
    nb, ns, n = 3 * spec.n_residues, spec.n_sidechain_atoms, n_frames
    x = (rng.uniform(0.13, 0.155, (n, nb - 1)), rng.uniform(1.7, 2.2, (n, nb - 2)),
         rng.uniform(-np.pi, np.pi, (n, nb - 3)), rng.uniform(0.13, 0.16, (n, ns)),
         rng.uniform(1.7, 2.2, (n, ns)),
         rng.uniform(-np.pi, np.pi, (n, sum(TRP_CAGE_SIDECHAIN_INFO.values()))))
    with torch.no_grad():
        xyz = backmap_sidechains_fast(spec, *(torch.tensor(v, device=device) for v in x))
    xyz = xyz.cpu().numpy()
    cd, ca, cdi, sd, sa, sdi = x
    return {k: np.asarray(v, np.float32) for k, v in (
        ("central_angles", ca), ("central_dihedrals", cdi), ("all_cartesians", xyz),
        ("central_distances", cd), ("side_angles", sa), ("side_dihedrals", sdi),
        ("side_distances", sd), ("central_cartesians", xyz[:, :nb]))}


def rigid_transform(seed: int) -> np.ndarray:
    """One rigid ``(4, 4)`` transform for row vectors (``[xyz, 1] @ M``): a
    random rotation and a shift of up to 2 nm, as ``tests/test_multimer.py``
    draws them."""
    rng = np.random.default_rng(seed)
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    m = np.eye(4)
    m[:3, :3], m[3, :3] = q.T, rng.uniform(-2, 2, 3)
    return m


def dimer_cvs(n_frames: int, lengths: tuple = (20, 20), seed: int = 0,
              device: str = "cuda", side: int | None = None) -> dict:
    """Synthetic multimer CVs: each protein's internals drawn from ``seed``
    as ``adc_cvs`` draws them, concatenated protein by protein; each
    protein backmapped from its own internals (float64 on ``device``) and
    the others placed by fixed rigid transforms (``tests/test_multimer.py``
    builds its dimer so); ``side`` sidechain dihedrals per protein,
    trp-cage's 37 by default."""
    from encodermap_tpu_torch.ops.backmap import backmap_multimer

    rng = np.random.default_rng(seed)
    n = n_frames
    parts = [(rng.uniform(0.13, 0.155, (n, 3 * L - 1)), rng.uniform(1.6, 2.4, (n, 3 * L - 2)),
              rng.uniform(-np.pi, np.pi, (n, 3 * L - 3))) for L in lengths]
    dist, ang, dih = (np.concatenate(x, axis=1) for x in zip(*parts))
    mats = np.broadcast_to(np.stack([rigid_transform(seed + i)
                                     for i in range(1, len(lengths))]),
                           (n, len(lengths) - 1, 4, 4))
    with torch.no_grad():
        cart = backmap_multimer(list(lengths), *(torch.tensor(np.ascontiguousarray(v),
                                                              device=device)
                                                 for v in (dist, ang, dih, mats)))
    if side is None:
        side = sum(TRP_CAGE_SIDECHAIN_INFO.values())
    side = rng.uniform(-np.pi, np.pi, (n, len(lengths) * side))
    return {k: np.asarray(v, np.float32) for k, v in zip(
        CV_KEYS, (ang, dih, cart.cpu().numpy(), dist, side))}


def time_chunks(emap, tag: str) -> tuple:
    """The chunk trainer alone: ms per step by CUDA events over 2 chunks
    (after one to warm up), and the device's busy time and idle share over
    one more (``device_split``). Returns (ms per step, busy ms per step)."""
    trainer, dev_data, state = emap._get_trainer(), emap._device_data(), emap.state
    steps = max(1, min(emap.p.steps_per_scan, emap.p.n_steps))

    def chunk():
        nonlocal state
        state, _ = trainer(state, dev_data)

    ms = time_ms(chunk, 2, warmup=1) / steps
    busy = device_split(chunk, ms, steps, tag)
    log(f"[{tag}] chunk trainer alone: {ms:.3f} ms/step (CUDA events, 2 chunks of "
        f"{steps} steps), {emap.p.batch_size / ms * 1e3:.0f} samples/s")
    return ms, busy


def check_reload(em, emap, cvs: dict, run_dir: Path, tag: str) -> np.ndarray:
    """A checkpoint reload must encode the training CVs bit for bit."""
    latent = emap.encode()
    again = em.AngleDihedralCartesianEncoderMap.from_checkpoint(cvs, run_dir)
    check(np.array_equal(again.encode(), latent),
          f"{tag}: reloaded checkpoint encodes differently")
    log(f"[{tag}] checkpoint reload encodes identically")
    return latent


def phase_adc_sidechains(em, fs, _build, run_dir: Path) -> dict:
    """Sidechain reconstruction at trp-cage scale: 20 residues with
    ``TRP_CAGE_SIDECHAIN_INFO`` (114 atoms), 4096 frames, [128,128,2],
    B=256, 100 steps in 2 chunks of 50. The sketch-map losses run on the
    kernels at D=206 periodic (central and side angles and dihedrals) and
    D=666 (the pairs of 20 CAs and 17 branch ends). Checks the launches,
    the loss, generate's bond lengths, a checkpoint round trip and the fast
    sidechain backmap against the sequential one in float64; times the
    step and the sidechain backmap; holds the kernels at both widths."""
    from encodermap_tpu_torch.models import adc
    from encodermap_tpu_torch.ops.backmap_sidechains import (
        backmap_sidechains,
        backmap_sidechains_fast,
    )
    from encodermap_tpu_torch.ops.distances import pairwise_dist

    tag = "adc sidechains"
    cvs = sidechain_cvs(4096, seed=3)
    p = adc_params(em, run_dir, 100, 50, reconstruct_sidechains=True,
                   sidechain_info=TRP_CAGE_SIDECHAIN_INFO)
    emap, hist, counts, wall = adc_train(em, _build, cvs, p, tag, 2, one_way=0, sidechain=1)
    spec = emap.sidechain_spec
    check(spec.n_atoms == 114 and spec.n_sidechain_atoms == 54,
          f"{tag}: the spec has {spec.n_atoms} atoms")
    chunks = hist["loss"].reshape(2, 50).mean(1)
    log(f"[{tag}] chunk mean loss {chunks.round(4).tolist()}")
    check(chunks[1] < chunks[0], f"{tag}: the loss did not fall")

    latent = check_reload(em, emap, cvs, run_dir, tag)
    xyz = emap.generate(latent[:64])
    check(xyz.shape == (64, 114, 3) and np.isfinite(xyz).all(),
          f"{tag}: generate shape {xyz.shape}")
    bb = np.linalg.norm(np.diff(xyz[:, :60], axis=1), axis=-1)
    bonds, col = [], 60
    for r, v in TRP_CAGE_SIDECHAIN_INFO.items():
        if v:
            chain = [(r - 1) * 3 + 1] + list(range(col, col + v + 1))
            bonds += list(zip(chain[:-1], chain[1:]))
            col += v + 1
    side = np.stack([np.linalg.norm(xyz[:, b] - xyz[:, a], axis=-1) for a, b in bonds], 1)
    bb_err = float(np.abs(bb - cvs["central_distances"].mean(0)).max())
    side_err = float(np.abs(side - cvs["side_distances"].mean(0)).max())
    log(f"[{tag}] generate {xyz.shape}: backbone bonds within {bb_err:.2e} nm and side "
        f"bonds within {side_err:.2e} nm of the training means")
    check(bb_err <= 1e-4 and side_err <= 1e-4, f"{tag}: generated bond lengths off the means")

    rows = np.random.default_rng(1).integers(0, 4096, 256)
    b64 = [torch.tensor(cvs[k][rows], device="cuda", dtype=torch.float64)
           for k in SIDECHAIN_KEYS]
    args = (b64[3], b64[0], b64[1], b64[6], b64[4], b64[5])
    with torch.no_grad():
        fast = backmap_sidechains_fast(spec, *args)
        seq = backmap_sidechains(spec, *args, angle_clip=None)
    seq_err = float((fast - seq).abs().max())
    log(f"[{tag}] fast sidechain backmap against the sequential sweep, float64, B=256: "
        f"max abs {seq_err:.3e} nm")
    check(seq_err <= 1e-9, f"{tag}: the fast sidechain backmap is off the sequential one")

    b = [torch.tensor(cvs[k][rows], device="cuda") for k in SIDECHAIN_KEYS]
    with torch.no_grad():
        lat = adc.encode_sidechains(emap.state.params, emap.p, b).contiguous()
        enc_inp = torch.cat([b[0], b[1], b[4], b[5]], dim=1)
        idx = torch.as_tensor(adc.sidechain_pwd_indices(emap.p, spec), device="cuda")
        pairs = pairwise_dist(b[2][:, idx], flat=True)
    check(enc_inp.shape[1] == 206 and pairs.shape[1] == 666,
          f"{tag}: kernel widths {enc_inp.shape[1]}, {pairs.shape[1]}")
    kern = adc_kernel_check(fs, {(206, 2 * math.pi): (enc_inp, lat, ADC_SIG),
                                 (666, float("inf")): (pairs, lat, ADC_SIG)}, tag, reps=20)

    ms, busy = time_chunks(emap, tag)
    grads = [t.clone().requires_grad_(True) for t in (b[0], b[1], b[4], b[5])]
    fwd_args = (b[3], grads[0], grads[1], b[6], grads[2], grads[3])
    out = backmap_sidechains_fast(spec, *fwd_args)
    g = torch.randn_like(out)
    ms_f = time_ms(lambda: backmap_sidechains_fast(spec, *fwd_args), 20)
    ms_b = time_ms(lambda: torch.autograd.grad(out, grads, g, retain_graph=True), 20)
    log(f"[{tag}] stages at B=256 (CUDA events): sidechain backmap fwd {ms_f:.4f} ms, bwd "
        f"{ms_b:.4f} ms; sigmoid kernels fwd+bwd "
        + ", ".join(f"D={D} {v['fwd'][1] + v['bwd'][1]:.4f} ms" for (D, _), v in kern.items())
        + f"; step {ms:.3f} ms, device busy {busy:.3f} ms")
    return dict(counts=counts, kernels=kern, ms=ms, wall=wall, sidechain=hold_sidechain())


def phase_adc_multimer(em, fs, _build, run_dir: Path) -> dict:
    """Multimer training on a trp-cage homodimer (``multimer_lengths=[20,
    20]``, 120 atoms), 4096 frames, [128,128,2], B=256, 100 steps in 2
    chunks of 50. The
    kernels run at D=304 periodic (angles, dihedrals, side dihedrals) and
    D=780 (the pairs of 40 CAs). Checks the launches, generate's shape and
    each protein's bond lengths (the second's once its decoded transform is
    undone), a checkpoint round trip; times the step; holds the kernels at
    both widths. Then diubiquitin as the benchmark's cell
    ``adc-diubi-dimer-b256`` trains it (``multimer_lengths=[76, 76]``,
    161 side dihedrals a chain, 1024 frames, 20 steps in 2 chunks): checks
    the launches (the one-way kernels at halves of 113 and 112 dihedrals,
    four a step each) and holds kernels 2-3 at its widths, D=1,224
    periodic and the 152^2 CA distance-matrix rows, against float64 as
    ``phase_featurize`` holds config 4's."""
    from encodermap_tpu_torch.ops.backmap import backmap_multimer

    tag = "adc multimer"
    cvs = dimer_cvs(4096, seed=4)
    p = adc_params(em, run_dir, 100, 50, multimer_training="homogeneous_transformation",
                   multimer_lengths=[20, 20])
    emap, hist, counts, wall = adc_train(em, _build, cvs, p, tag, 2, one_way=4)
    first, last = hist["loss"][:10].mean(), hist["loss"][-10:].mean()
    log(f"[{tag}] mean loss of the first 10 steps {first:.4f}, of the last 10 {last:.4f}")
    check(last < first, f"{tag}: the loss did not fall")

    latent = check_reload(em, emap, cvs, run_dir, tag)
    xyz = emap.generate(latent[:64])
    check(xyz.shape == (64, 120, 3) and np.isfinite(xyz).all(),
          f"{tag}: generate shape {xyz.shape}")
    mats = emap.decode(latent[:64])[3].astype(np.float64)  # (64, 1, 4, 4)
    second = np.einsum("bnj,bjk->bnk", xyz[:, 60:].astype(np.float64) - mats[:, 0, None, 3, :3],
                       np.linalg.inv(mats[:, 0, :3, :3]))
    means = cvs["central_distances"].mean(0)
    errs = [float(np.abs(np.linalg.norm(np.diff(x, axis=1), axis=-1) - m).max())
            for x, m in ((xyz[:, :60], means[:59]), (second, means[59:]))]
    cond = float(np.linalg.cond(mats[:, 0, :3, :3]).max())
    log(f"[{tag}] generate {xyz.shape}: bond lengths within {errs[0]:.2e} nm (protein 1) "
        f"and {errs[1]:.2e} nm (protein 2, its decoded transform undone; largest "
        f"condition number {cond:.1f}) of the training means")
    check(max(errs) <= 1e-4, f"{tag}: generated bond lengths off the means")

    rows = np.random.default_rng(1).integers(0, 4096, 256)
    inputs = adc_kernel_inputs(emap, cvs, rows)
    check(set(inputs) == {(304, 2 * math.pi), (780, float("inf"))},
          f"{tag}: kernel widths {sorted(inputs)}")
    kern = adc_kernel_check(fs, inputs, tag, reps=20)

    ms, busy = time_chunks(emap, tag)
    b = [torch.tensor(cvs[k][rows], device="cuda") for k in CV_KEYS]
    ang, dih = (t.clone().requires_grad_(True) for t in (b[0], b[1]))
    eye = torch.eye(4, device="cuda").expand(256, 1, 4, 4).clone().requires_grad_(True)
    out = backmap_multimer([20, 20], b[3], ang, dih, eye)
    g = torch.randn_like(out)
    ms_f = time_ms(lambda: backmap_multimer([20, 20], b[3], ang, dih, eye), 20)
    ms_b = time_ms(lambda: torch.autograd.grad(out, (ang, dih, eye), g, retain_graph=True), 20)
    log(f"[{tag}] stages at B=256 (CUDA events): multimer backmap fwd {ms_f:.4f} ms, bwd "
        f"{ms_b:.4f} ms; sigmoid kernels fwd+bwd "
        + ", ".join(f"D={D} {v['fwd'][1] + v['bwd'][1]:.4f} ms" for (D, _), v in kern.items())
        + f"; step {ms:.3f} ms, device busy {busy:.3f} ms")

    ubi = dimer_cvs(1024, lengths=(76, 76), seed=6, side=161)
    p = adc_params(em, run_dir / "diubi", 20, 10,
                   multimer_training="homogeneous_transformation", multimer_lengths=[76, 76])
    emap, _, counts_u, _ = adc_train(em, _build, ubi, p, f"{tag} diubi", 2, one_way=4)
    inputs = adc_kernel_inputs(emap, ubi, np.arange(256))
    check(set(inputs) == {(1224, 2 * math.pi), (152 ** 2, float("inf"))},
          f"{tag} diubi: kernel widths {sorted(inputs)}")
    kern_u = adc_kernel_check(fs, inputs, f"{tag} diubi", oracle=True)
    counts = {k: counts.get(k, 0) + counts_u.get(k, 0) for k in counts.keys() | counts_u.keys()}
    return dict(counts=counts, kernels=kern, kernels_diubi=kern_u, ms=ms, wall=wall)


#: M1-linked diubiquitin (BASELINE config 4): 152 residues, 1,066 atoms,
#: 322 side dihedrals in ``synthetic_protein``'s form
DIUBI = UBIQUITIN * 2
#: tolerances of the card's CVs against the CPU's: nm for distances and
#: Cartesians, rad for angles and (modulo 2 pi) dihedrals
CV_TOL = {"central_distances": 1e-6, "central_cartesians": 1e-6,
          "central_angles": 1e-5, "central_dihedrals": 1e-5, "side_dihedrals": 1e-5}


def cv_errors(a: dict, b: dict) -> dict:
    """Largest difference of each CV of ``a`` from ``b``; dihedrals
    compared modulo 2 pi, NaNs (alignment padding) where both have them."""
    out = {}
    for k in CV_TOL:
        x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        check(x.shape == y.shape and np.array_equal(np.isnan(x), np.isnan(y)),
              f"CV {k}: shapes {x.shape} {y.shape} or NaN patterns differ")
        d = x - y
        if "dihedral" in k:
            d = (d + np.pi) % (2 * np.pi) - np.pi
        out[k] = float(np.nanmax(np.abs(d))) if d.size else 0.0
    return out


def check_rotated(top, seed: np.ndarray, xyz: np.ndarray, quads: np.ndarray,
                  targets: np.ndarray, tag: str) -> tuple:
    """Generated frames ``xyz`` against the seed: every rotatable dihedral
    at its target (1e-3 rad), every unrotatable one at the seed's value,
    every bond ``guess_bonds`` finds in the seed at its seed length (1e-4
    nm); float64 on the host. Returns (dihedral error, bond error)."""
    from encodermap_tpu_torch.misc.backmapping_offline import guess_bonds, near_and_far_masks
    from encodermap_tpu_torch.ops import geometry as geom

    bonds = np.asarray(guess_bonds(top, seed))
    _, rot = near_and_far_masks(top, quads, bonds=[tuple(b) for b in bonds])
    x64 = torch.tensor(xyz, dtype=torch.float64)
    got = geom.compute_dihedrals(x64, quads).numpy()
    want = np.where(rot, targets, geom.compute_dihedrals(
        torch.tensor(seed[None], dtype=torch.float64), quads).numpy())
    dih_err = float(np.abs((got - want + np.pi) % (2 * np.pi) - np.pi).max())
    lens = np.linalg.norm(xyz[:, bonds[:, 0]] - xyz[:, bonds[:, 1]], axis=-1)
    bond_err = float(np.abs(lens - np.linalg.norm(seed[bonds[:, 0]] - seed[bonds[:, 1]],
                                                   axis=-1)).max())
    log(f"[{tag}] {int(rot.sum())} of {len(quads)} dihedrals rotatable: they hit their "
        f"targets within {dih_err:.2e} rad (the rest keep the seed's); {len(bonds)} bonds "
        f"within {bond_err:.2e} nm of the seed frame's")
    check(dih_err <= 1e-3, f"{tag}: generated dihedrals off their targets")
    check(bond_err <= 1e-4, f"{tag}: generated bond lengths off the seed's")
    return dih_err, bond_err


def phase_featurize(em, fs, _build, run_dir: Path, n_frames: int = 2048) -> dict:
    """BASELINE config 4 on the card: M1-linked diubiquitin (152 residues,
    1,066 atoms) in two trajectories of ``n_frames`` frames, written as PDB
    + XTC. ``em.load`` -> ``load_CVs("all", ensemble=True)`` on the card,
    held against the CPU's; the ADC trained on the ``TrajEnsemble`` itself
    ([128,128,2], B=256, 100 steps; kernels 2-3 at D=1,229 periodic and on
    the 152^2 CA distance-matrix rows, twice a step each); generated
    conformations rotated onto the topology (``backend="topology"``, 453
    central dihedrals; ``"mdtraj"``, 775 with the side dihedrals), checked
    for their dihedrals and bond lengths, written to XTC and read back.
    Times XTC reading, featurization (host clock ending in a sync, and the
    device alone on resident coordinates, with the device's idle share over
    the blocks), training and generation."""
    from encodermap_tpu_torch.data.pdb import write_pdb
    from encodermap_tpu_torch.data.xtc import XTCReader, write_xtc
    from encodermap_tpu_torch.loading.features import SideChainDihedrals
    from encodermap_tpu_torch.loading.featurizer import SingleTrajFeaturizer

    tag = "featurize"
    smi = smi_line()  # beside every throughput this leg prints
    run_dir.mkdir(parents=True, exist_ok=True)
    top, xyz = synthetic_protein(DIUBI, 2 * n_frames, seed=5, device="cuda")
    info = top.sidechain_info()
    check(len(info) == 152 and sum(info.values()) == 322,
          f"{tag}: diUbi has {len(info)} residues, {sum(info.values())} side dihedrals")
    pdb = str(run_dir / "diubi.pdb")
    write_pdb(pdb, top, xyz[:1])
    xtcs = [str(run_dir / f"diubi_{i}.xtc") for i in range(2)]
    for i, path in enumerate(xtcs):
        write_xtc(path, xyz[i * n_frames:(i + 1) * n_frames])
    t0 = time.perf_counter()
    back = XTCReader(xtcs[0]).read()[0]
    t_read = time.perf_counter() - t0
    q_err = float(np.abs(back - xyz[:n_frames]).max())
    log(f"[{tag}] diUbi: {top.n_atoms} atoms, {sum(info.values())} side dihedrals; XTC read "
        f"{n_frames / t_read:.0f} frames/s ({t_read * 1e3:.1f} ms for {n_frames} frames; "
        f"{smi}); quantized within {q_err:.2e} nm")
    check(q_err <= 5.01e-4, f"{tag}: XTC coordinates off by {q_err}")

    trajs = em.load(xtcs, pdb)
    trajs.load_trajs()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trajs.load_CVs("all", ensemble=True)
    torch.cuda.synchronize()
    t_feat = time.perf_counter() - t0
    cpu = em.load(xtcs, pdb)
    cpu.load_trajs()
    t0 = time.perf_counter()
    cpu.load_CVs("all", ensemble=True, device="cpu")
    t_cpu = time.perf_counter() - t0
    errs = cv_errors(trajs.CVs, cpu.CVs)
    log(f"[{tag}] load_CVs('all', ensemble=True) on the card {2 * n_frames / t_feat:.0f} "
        f"frames/s (host clock, ending in a sync; {t_feat * 1e3:.1f} ms; {smi}), on the CPU "
        f"{2 * n_frames / t_cpu:.0f} frames/s; card against CPU: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    check(all(v <= CV_TOL[k] for k, v in errs.items()), f"{tag}: card CVs off the CPU's")

    feat = SingleTrajFeaturizer(trajs[0], device="cuda")
    feat.add_list_of_feats("all")
    run, slice_xyz = feat._get_runner()
    resident = torch.tensor(slice_xyz(np.asarray(trajs[0].xyz, np.float32)), device="cuda")
    ms_dev = time_ms(lambda: run(resident, None, False), 10)
    def one():
        feat.get_output_for(trajs[0])

    one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one()
    torch.cuda.synchronize()
    ms_host = (time.perf_counter() - t0) * 1e3
    log(f"[{tag}] one trajectory's blocks ({n_frames} frames): device alone on resident "
        f"coordinates {ms_dev:.3f} ms ({n_frames / ms_dev * 1e3:.0f} frames/s, CUDA events); "
        f"with upload and download {ms_host:.3f} ms (host clock; {smi})")
    busy = device_split(one, ms_host, 1, f"{tag} blocks")
    log(f"[{tag}] device idle share over the blocks "
        + (f"{1 - busy / ms_host:.3f}" if busy else "not measured") + f" (torch.profiler; {smi})")

    p = adc_params(em, run_dir / "adc", 100, 100)
    emap, hist, counts, wall = adc_train(em, _build, trajs, p, f"{tag} adc", 2)
    first, last = hist["loss"][:10].mean(), hist["loss"][-10:].mean()
    log(f"[{tag} adc] mean loss of the first 10 steps {first:.4f}, of the last 10 {last:.4f}")
    check(last < first, f"{tag}: the ADC loss did not fall")
    cvs = trajs.CVs
    rows = np.random.default_rng(1).integers(0, 2 * n_frames, 256)
    inputs = adc_kernel_inputs(emap, cvs, rows)
    check(set(inputs) == {(1229, 2 * math.pi), (152 ** 2, float("inf"))},
          f"{tag}: kernel widths {sorted(inputs)}")
    # every pair of diUbi frames sits near one high-D distance (11.2 +- 0.6
    # at D=1,229), so the sigmoid terms of a gradient row nearly cancel and
    # the plain float32 gradient strays ~3e-4 from float64: held to float64
    kern = adc_kernel_check(fs, inputs, f"{tag} adc", oracle=True)
    ms, _ = time_chunks(emap, f"{tag} adc")
    log(f"[{tag} adc] train() {p.n_steps * p.batch_size / wall:.0f} samples/s (host clock), "
        f"{ms:.3f} ms/step (CUDA events; {smi})")

    latent = emap.encode()
    seed = np.asarray(trajs[0].xyz[0], np.float64)
    chain = top.central_atom_indices()
    quads = np.stack([chain[:-3], chain[1:-2], chain[2:-1], chain[3:]], axis=1)
    out = {}
    for backend in ("topology", "mdtraj"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen = emap.generate(latent[:256], backend=backend, top=trajs[0]
                            if backend == "topology" else None)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
        decoded = emap.decode(latent[:256])
        q, targets = quads, decoded[1]
        if backend == "mdtraj":
            q = np.vstack([quads, SideChainDihedrals(top)._indices])
            targets = np.concatenate([decoded[1], decoded[2]], axis=1)
        check(gen.shape == (256, top.n_atoms, 3) and np.isfinite(gen).all(),
              f"{tag}: generate({backend}) shape {gen.shape}")
        log(f"[{tag}] generate(backend={backend!r}) {gen.shape}, {len(q)} dihedrals swept: "
            f"{256 / t_gen:.0f} conformations/s ({t_gen * 1e3:.1f} ms, host clock; {smi})")
        check_rotated(top, seed, gen.astype(np.float64), q, targets, f"{tag} {backend}")
        out[backend] = 256 / t_gen
    path = str(run_dir / "generated.xtc")
    write_xtc(path, gen)
    again = em.load(path, pdb)
    r_err = float(np.abs(np.asarray(again.xyz) - gen).max())
    log(f"[{tag}] generated frames written to XTC and read back: {again.n_frames} frames "
        f"within {r_err:.2e} nm")
    check(again.n_frames == 256 and r_err <= 5.01e-4, f"{tag}: generated XTC round trip")
    return dict(counts=counts, kernels=kern, ms=ms, wall=wall, trajs=trajs, cvs=cvs,
                emap=emap, top=top, xyz=xyz, pdb=pdb)


# ------------------------------------------------------- slice 6a: analysis
def dssp_mismatches(top, xyz: np.ndarray, frames: np.ndarray, tag: str) -> int:
    """Where the card's and the CPU's DSSP strings differ in ``frames``,
    the H-bond matrices of those frames must differ only at energies within
    1e-9 kcal/mol of the -0.5 cut (float64 rounding on either side); each
    such bond is printed. Returns the number of those bonds."""
    from encodermap_tpu_torch.ops.dssp import dssp_backbone, kabsch_sander_energy

    near = 0
    for f in frames:
        hb, energy = [], None
        for dev in ("cuda", "cpu"):
            n, ca, c, o, h, is_pro, brk, _ = dssp_backbone(
                torch.as_tensor(xyz[f:f + 1], device=dev), top)
            e, allowed = kabsch_sander_energy(n, ca, c, o, is_proline=is_pro, h=h,
                                              chain_break=brk)
            hb.append(((e < -0.5) & allowed).cpu().numpy()[0])
            energy = e.cpu().numpy()[0] if dev == "cpu" else energy
        flips = np.argwhere(hb[0] != hb[1])
        check(len(flips) > 0, f"{tag}: frame {f} strings differ with equal H-bond matrices")
        for i, j in flips:
            log(f"[{tag}] frame {f}: bond O({i})..H-N({j}) at {energy[i, j]:.15f} kcal/mol "
                f"is {'on' if hb[0][i, j] else 'off'} on the card, "
                f"{'on' if hb[1][i, j] else 'off'} on the CPU")
            check(abs(energy[i, j] + 0.5) < 1e-9,
                  f"{tag}: frame {f} bond ({i}, {j}) differs {energy[i, j] + 0.5:.3e} "
                  f"kcal/mol from the cut")
            near += 1
    return near


def phase_analysis(em, fs, _build, run_dir: Path, feat: dict) -> dict:
    """Slice 6a, the analysis path of the EncoderMap tutorials, on
    ``phase_featurize``'s diUbi (1,066 atoms, 2 x 2,048 frames): the frames
    written as DCD and TRR by the port's writers and the first frame as GRO;
    each read by ``em.load`` and held to the array written (TRR bit for
    bit, DCD 1e-6 nm, GRO 5e-4 nm) and the GRO's topology to the PDB's; a
    DCD + TRR ensemble featurized on the card and held to the CPU
    (``CV_TOL``). DSSP on the card over all 4,096 frames, held to the CPU
    on 128. ``MolData`` on the DCD. The RMSD matrix at ``max_frames=500``
    on the card (symmetric, zero diagonal, 32 frames held to the CPU), and
    the cluster of the most populated cell of a 16 x 16 grid over the
    latent map of ``phase_featurize``'s ADC through ``cluster_to_dict`` and
    ``rmsd_centroid_of_cluster``. Last, a reconstruct-sidechain ADC trained
    on a synthetic trp-cage ``TrajEnsemble`` (DCD + TRR, 50 steps, B=256,
    ``sidechain_info`` read off the topology; kernels 2-3 twice a step) and
    8 conformations generated onto its topology."""
    from types import SimpleNamespace

    from encodermap_tpu_torch.data.formats import write_dcd, write_trr
    from encodermap_tpu_torch.data.pdb import write_pdb
    from encodermap_tpu_torch.misc.clustering import (cluster_to_dict, pairwise_rmsd_matrix,
                                                      rmsd_centroid_of_cluster)
    from encodermap_tpu_torch.ops.dssp import compute_dssp

    tag = "analysis"
    smi = smi_line()
    run_dir.mkdir(parents=True, exist_ok=True)
    top, xyz, pdb = feat["top"], feat["xyz"], feat["pdb"]
    n = len(xyz) // 2
    dcd, trr, gro = (str(run_dir / f) for f in ("diubi_0.dcd", "diubi_1.trr", "diubi.gro"))
    write_dcd(dcd, xyz[:n])
    write_trr(trr, xyz[n:])
    write_gro(gro, top, xyz[0])

    # --- formats
    t0 = time.perf_counter()
    from_dcd = em.load(dcd, pdb)
    x_dcd = np.asarray(from_dcd.xyz)
    t_dcd = time.perf_counter() - t0
    t0 = time.perf_counter()
    x_trr = np.asarray(em.load(trr, pdb).xyz)
    t_trr = time.perf_counter() - t0
    from_gro = em.load(gro)
    dcd_err = float(np.abs(x_dcd - xyz[:n]).max())
    gro_err = float(np.abs(np.asarray(from_gro.xyz) - xyz[:1]).max())
    log(f"[{tag}] DCD {x_dcd.shape} read at {n / t_dcd:.0f} frames/s, within {dcd_err:.2e} nm; "
        f"TRR read at {n / t_trr:.0f} frames/s, bit for bit {np.array_equal(x_trr, xyz[n:])}; "
        f"GRO within {gro_err:.2e} nm (host clock; {smi})")
    check(x_dcd.shape == (n, top.n_atoms, 3) and dcd_err <= 1e-6, f"{tag}: DCD coordinates")
    check(np.array_equal(x_trr, xyz[n:]), f"{tag}: TRR coordinates not bit for bit")
    check(from_gro.n_frames == 1 and gro_err <= 5.01e-4, f"{tag}: GRO coordinates")

    def table(t):
        return ([(a.name, a.element) for a in t.atoms],
                [(r.name, r.resSeq) for r in t.residues])

    check(table(from_gro.top) == table(top), f"{tag}: the GRO's topology differs from the PDB's")
    log(f"[{tag}] GRO topology: {from_gro.top.n_atoms} atoms, {from_gro.top.n_residues} "
        f"residues, names and elements as the PDB's")
    ens = em.load([dcd, trr], pdb)
    ens.load_trajs()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ens.load_CVs("all", ensemble=True)
    torch.cuda.synchronize()
    t_feat = time.perf_counter() - t0
    cpu = em.load([dcd, trr], pdb)
    cpu.load_CVs("all", ensemble=True, device="cpu")
    errs = cv_errors(ens.CVs, cpu.CVs)
    log(f"[{tag}] DCD + TRR ensemble featurized on the card at {2 * n / t_feat:.0f} frames/s "
        f"(host clock ending in a sync; {smi}); card against CPU: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    check(all(v <= CV_TOL[k] for k, v in errs.items()), f"{tag}: card CVs off the CPU's")

    # --- DSSP
    frames = SimpleNamespace(top=top, xyz=np.concatenate([x_dcd, x_trr]))
    compute_dssp(SimpleNamespace(top=top, xyz=frames.xyz[:8]))  # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ss = compute_dssp(frames)
    t_ss = time.perf_counter() - t0
    check(ss.shape == (2 * n, top.n_residues), f"{tag}: DSSP shape {ss.shape}")
    head = SimpleNamespace(top=top, xyz=frames.xyz[:128])
    t0 = time.perf_counter()
    ref = compute_dssp(head, device="cpu")
    t_cpu = time.perf_counter() - t0
    ss8, ref8 = compute_dssp(head, simplified=False), compute_dssp(head, simplified=False,
                                                                    device="cpu")
    bad = np.flatnonzero((ss[:128] != ref).any(1) | (ss8 != ref8).any(1))
    near = dssp_mismatches(top, frames.xyz, bad, tag) if len(bad) else 0
    device_split(lambda: compute_dssp(frames), t_ss * 1e3, 1, f"{tag} dssp")
    share = {k: float((ss == k).mean()) for k in "HEC"}
    log(f"[{tag}] DSSP on the card: {2 * n} frames x {top.n_residues} residues at "
        f"{2 * n / t_ss:.0f} frames/s (host clock, float64; {smi}); the CPU "
        f"{128 / t_cpu:.0f} frames/s; 3- and 8-state strings of 128 frames equal the CPU's "
        f"but in {len(bad)} frames ({near} bonds within 1e-9 kcal/mol of the cut); "
        f"H {share['H']:.3f}, E {share['E']:.3f}, C {share['C']:.3f}")

    # --- MolData
    md = em.MolData(from_dcd)
    cvs = from_dcd.CVs
    for attr, key in (("angles", "central_angles"), ("dihedrals", "central_dihedrals"),
                      ("central_cartesians", "central_cartesians"),
                      ("lengths", "central_distances"), ("sidedihedrals", "side_dihedrals")):
        check(np.array_equal(getattr(md, attr), np.asarray(cvs[key])),
              f"{tag}: MolData.{attr} differs from load_CVs' {key}")
    check(np.array_equal(md.cartesians, x_dcd), f"{tag}: MolData.cartesians")
    log(f"[{tag}] MolData on the DCD: its six arrays equal load_CVs' "
        f"({', '.join(f'{k} {getattr(md, k).shape}' for k in ('angles', 'dihedrals', 'cartesians', 'central_cartesians', 'lengths', 'sidedihedrals'))})")

    # --- RMSD clustering
    pairwise_rmsd_matrix(frames.xyz[:16])  # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    D = pairwise_rmsd_matrix(frames.xyz, max_frames=500)
    ms_rmsd = (time.perf_counter() - t0) * 1e3
    sub = np.linspace(0, 2 * n - 1, 500).astype(int)
    D_cpu = pairwise_rmsd_matrix(frames.xyz[sub[:32]], device="cpu")
    asym, diag = float(np.abs(D - D.T).max()), float(np.abs(np.diag(D)).max())
    cpu_err = float(np.abs(D[:32, :32] - D_cpu).max())
    log(f"[{tag}] pairwise_rmsd_matrix, 500 frames x {top.n_atoms} atoms: {ms_rmsd:.1f} ms "
        f"(host clock ending in a copy to the host; {smi}); asymmetry {asym:.2e} nm, "
        f"diagonal {diag:.2e} nm, 32 frames against the CPU {cpu_err:.2e} nm; RMSD "
        f"{D.min():.3f}..{D.max():.3f} nm")
    check(D.shape == (500, 500) and asym <= 1e-5 and diag <= 1e-5, f"{tag}: RMSD matrix")
    device_split(lambda: pairwise_rmsd_matrix(frames.xyz, max_frames=500), ms_rmsd, 1,
                 f"{tag} rmsd")
    check(cpu_err <= 1e-5, f"{tag}: RMSD matrix off the CPU's")
    latent = feat["emap"].encode()
    cells = [np.clip(((latent[:, k] - latent[:, k].min()) / np.ptp(latent[:, k]) * 16)
                     .astype(int), 0, 15) for k in (0, 1)]
    cell = cells[0] * 16 + cells[1]
    members = np.flatnonzero(cell == np.bincount(cell).argmax())
    membership = np.full(2 * n, -1)
    membership[members] = 0
    ens.load_CVs(membership, attr_name="cluster_membership")
    t0 = time.perf_counter()
    views = cluster_to_dict(ens.cluster(0))
    t_ctd = time.perf_counter() - t0
    check(np.array_equal(views["series"], np.zeros(len(members)))
          and views["joined"].n_frames == len(members)
          and views["stacked"].n_atoms == len(members) * top.n_atoms
          and np.isfinite(views["joined"].xyz).all(), f"{tag}: cluster_to_dict views")
    centre, dist = rmsd_centroid_of_cluster(frames.xyz[members])
    centre_cpu, dist_cpu = rmsd_centroid_of_cluster(frames.xyz[members], device="cpu")
    c_err = float(np.abs(dist - dist_cpu).max())
    log(f"[{tag}] most populated latent cell (16 x 16 grid): {len(members)} frames; "
        f"cluster_to_dict {t_ctd * 1e3:.1f} ms (host); centroid frame {members[centre]} "
        f"(the CPU's {members[centre_cpu]}), its matrix within {c_err:.2e} nm of the CPU's")
    check(centre == centre_cpu and c_err <= 1e-5, f"{tag}: the centroid differs from the CPU's")

    # --- a reconstruct-sidechain ADC on a trajectory ensemble, generated
    # onto its topology
    sc_top, sc_xyz = synthetic_protein(TRP_CAGE, 2048, seed=6, device="cuda")
    sc_pdb = str(run_dir / "trp.pdb")
    write_pdb(sc_pdb, sc_top, sc_xyz[:1])
    write_dcd(run_dir / "trp_0.dcd", sc_xyz[:1024])
    write_trr(run_dir / "trp_1.trr", sc_xyz[1024:])
    trp = em.load([str(run_dir / "trp_0.dcd"), str(run_dir / "trp_1.trr")], sc_pdb)
    trp.load_CVs("full", ensemble=True)
    p = adc_params(em, run_dir / "sc", 50, 50, reconstruct_sidechains=True)
    emap, hist, counts, wall = adc_train(em, _build, trp, p, f"{tag} sidechains", 2,
                                         one_way=0, sidechain=1)
    check(p.sidechain_info == sc_top.sidechain_info(),
          f"{tag}: sidechain_info {p.sidechain_info} is not the topology's")
    z = emap.encode()[:8]
    gen = emap.generate(z, backend="topology", top=trp[0])
    check(gen.shape == (8, sc_top.n_atoms, 3) and np.isfinite(gen).all(),
          f"{tag}: generate shape {gen.shape}")
    chain = sc_top.central_atom_indices()
    quads = np.stack([chain[:-3], chain[1:-2], chain[2:-1], chain[3:]], axis=1)
    check_rotated(sc_top, np.asarray(trp[0].xyz[0], np.float64), gen.astype(np.float64),
                  quads, emap.decode(z)[1], f"{tag} sidechains topology")
    return dict(counts=counts, dssp_fps=2 * n / t_ss, rmsd_ms=ms_rmsd)


# --------------------------------------------------------- slice 5: scale-out
class Recorder:
    """Passes a source's superbatches on and keeps them."""

    def __init__(self, source) -> None:
        self.source, self.seen = source, []

    def __iter__(self):
        return self

    def __next__(self):
        sb = next(self.source)
        self.seen.append(sb)
        return sb


def _params_copy(emap) -> dict:
    from encodermap_tpu_torch.train.core import tree_map

    return tree_map(lambda t: t.detach().cpu().numpy().copy(), emap.state.params)


def _same_params(a, b) -> bool:
    from encodermap_tpu_torch.train.core import tree_leaves

    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a.state.params),
                                                 tree_leaves(b.state.params)))


#: config 5 (BASELINE.md line 36, bench.py:323-392): 1,000,000 frames of 6
#: features, [128,128,2], B=256, 1000-step superbatches
STREAM_FRAMES, STREAM_B, STREAM_STEPS = 1_000_000, 256, 1000


def phase_streaming(em, fs, _build, run_dir: Path) -> dict:
    """BASELINE config 5 at full width: a million 6-feature frames from seed
    0, written once as a 24 MB ``.npy`` and read as a memmap by the port's
    ``train/core.py::ArrayBatchSource`` (the sampler of ``HDF5BatchSource``;
    the card machine has no h5py); ``EncoderMap.train_streaming`` over 3
    superbatches of 1000 steps at B=256, [128,128,2] (the port's
    PrefetchSource, pinned uploads on a side stream, kernels 2-3 once each a
    step). Checks the launches, the uploads, that the loss falls, and that
    the in-memory chunk trainer fed the same batches ends with the same
    parameters bit for bit. Times the source alone, ``train_streaming``, one
    chunk (host clock ending in a sync, and the device's busy time and idle
    share), two chunks with prefetch 2 against none; holds kernels 2-3 at
    this path's shape."""
    from encodermap_tpu_torch.models import sequential as seq
    from encodermap_tpu_torch.train import core

    tag = "streaming"
    smi = smi_line()
    run_dir.mkdir(parents=True, exist_ok=True)
    path = run_dir / "frames.npy"
    np.save(path, np.random.default_rng(0).standard_normal((STREAM_FRAMES, 6))
            .astype(np.float32))
    frames = np.load(path, mmap_mode="r")
    B, S = STREAM_B, STREAM_STEPS
    src = core.ArrayBatchSource([(frames,)], B, S, seed=0)
    t0 = time.perf_counter()
    for _ in range(3):
        next(src)
    t_src = time.perf_counter() - t0
    log(f"[{tag}] source alone (8 windows of a 1M x 6 memmap, carved into ({S}, {B}, 6)): "
        f"{3 * S * B / t_src:.0f} samples/s ({t_src / 3 * 1e3:.1f} ms a superbatch; {smi})")

    kw = dict(n_neurons=[128, 128, 2], batch_size=B, steps_per_scan=S, seed=0,
              periodicity=float("inf"))
    proto = np.random.default_rng(1).standard_normal((64, 6)).astype(np.float32)
    emap = em.EncoderMap(em.Parameters(main_path=str(run_dir / "run"), n_steps=3 * S, **kw),
                         proto)
    init = _params_copy(emap)
    uploaders = []
    plain_uploader = core.PinnedUploader

    class Seen(plain_uploader):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            uploaders.append(self)

    source = Recorder(core.ArrayBatchSource([(frames,)], B, S, seed=0))
    core.PinnedUploader = Seen
    try:
        torch.cuda.synchronize()
        _build.launch_counts.clear()
        t0 = time.perf_counter()
        hist = emap.train_streaming(source)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_build.launch_counts)
    finally:
        core.PinnedUploader = plain_uploader
    n = 3 * S
    check(counts.get("sigmoid_fwd") == n and counts.get("sigmoid_bwd") == n,
          f"{tag}: sigmoid kernels launched {counts}, expected {n} each")
    check(not counts.get("fused_train") and not counts.get("fused_train_cluster"),
          f"{tag}: a fused train kernel ran")
    up = uploaders[0] if len(uploaders) == 1 else None
    check(up is not None and up.copies == 3 and up.stream is not None
          and up.stream != torch.cuda.current_stream(),
          f"{tag}: the superbatches did not go through one pinned uploader on a side stream")
    first, last = hist["loss"][:100].mean(), hist["loss"][-100:].mean()
    check(bool(np.isfinite(hist["loss"]).all()) and last < first, f"{tag}: the loss did not fall")
    log(f"[{tag}] train_streaming: {n} steps, launches {counts}; {up.copies} superbatches "
        f"uploaded from pinned memory on a side stream; loss first 100 steps {first:.4f} -> "
        f"last 100 {last:.4f}; {n * B / wall:.0f} samples/s ({wall:.2f} s, host clock ending "
        f"in a sync; {smi})")

    data = np.concatenate([sb[0].reshape(-1, 6) for sb in source.seen[:3]])
    ref = em.EncoderMap(em.Parameters(main_path=str(run_dir / "ref"), n_steps=n,
                                      fused_trainer=False, **kw), data, model_params=init,
                        read_only=True)
    ref.train(index_stream=iter(np.arange(n * B).reshape(3, S, B)))
    torch.cuda.synchronize()
    same = _same_params(emap, ref)
    log(f"[{tag}] the in-memory chunk trainer fed the same {n} batches as injected indices: "
        f"parameters bit-identical {same}")
    check(same, f"{tag}: streamed parameters differ from the chunk trainer's on the same batches")

    timing = em.EncoderMap(em.Parameters(main_path=str(run_dir / "t"), n_steps=n, **kw), proto,
                           model_params=init, read_only=True)

    def one_chunk(steps=S):
        timing.train_streaming(iter([(source.seen[0][0][:steps],)]), n_steps=steps)

    one_chunk()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_chunk()
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / S
    # the profiler's summary of a 1000-step chunk (~300k device operations)
    # is slow on the host: its first 100 steps, per step
    busy = device_split(lambda: one_chunk(100), ms_step, 100, tag)
    out = {}
    for depth in (2, 0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        core.run_streaming(timing, core.ArrayBatchSource([(frames,)], B, S, seed=1), 2 * S,
                           prefetch=depth)
        torch.cuda.synchronize()
        out[depth] = (time.perf_counter() - t0) * 1e3
    log(f"[{tag}] one chunk: {ms_step:.3f} ms/step (host clock ending in a sync), device busy "
        f"{busy:.3f} ms/step (a 100-step chunk); two chunks from the memmap: prefetch 2 "
        f"{out[2]:.1f} ms, prefetch 0 {out[0]:.1f} ms ({smi})")

    sb = torch.tensor(source.seen[0][0][0], device="cuda")
    with torch.no_grad():
        lat = seq.encode(emap.state.params, emap.p, sb).contiguous()
    kern = hold_sigmoid(fs, sb, lat, tuple(emap.p.dist_sig_parameters), float("inf"),
                        f"{tag} sigmoid B={B} D=6 euclid", reps=20, plain_reps=5)
    return dict(counts=counts, kernels={(6, False): kern}, wall=wall, ms_step=ms_step,
                superbatches=source.seen[:2], init=init, kw=kw, proto=proto)


def phase_adc_streaming(em, fs, _build, run_dir: Path, feat: dict) -> dict:
    """The ADC's ``train_streaming`` on the card: tuple superbatches of the
    five CVs carved from ``phase_featurize``'s diUbi ensemble by
    ``train/core.py::ArrayBatchSource``, B=256, 2 superbatches of 50 steps.
    Checks the launches (kernels 2-3 twice a step each), that the loss
    falls; holds kernels 2-3 at D=1,229 periodic and 23,104 to float64 (as
    ``phase_featurize`` does)."""
    from encodermap_tpu_torch.train import core

    tag = "adc streaming"
    smi = smi_line()
    cvs = feat["cvs"]
    arrays = []
    for k in CV_KEYS:
        a = np.asarray(cvs[k], np.float32)
        arrays.append(a.reshape(len(a), -1, 3) if k == "central_cartesians" and a.ndim == 2
                      else a)
    p = adc_params(em, run_dir, 100, 50)
    emap = em.AngleDihedralCartesianEncoderMap(cvs, p)
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    hist = emap.train_streaming(core.ArrayBatchSource([arrays], 256, 50, seed=2))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.launch_counts)
    check(counts.get("sigmoid_fwd") == 200 and counts.get("sigmoid_bwd") == 200,
          f"{tag}: sigmoid kernels launched {counts}, expected 200 each")
    first, last = hist["loss"][:10].mean(), hist["loss"][-10:].mean()
    check(bool(np.isfinite(hist["loss"]).all()) and last < first, f"{tag}: the loss did not fall")
    log(f"[{tag}] diUbi, 2 superbatches of (50, 256, ...): launches {counts}; loss first 10 "
        f"steps {first:.4f} -> last 10 {last:.4f}; {100 * 256 / wall:.0f} samples/s "
        f"({wall:.2f} s, host clock ending in a sync; {smi})")
    rows = np.random.default_rng(3).integers(0, len(arrays[0]), 256)
    inputs = adc_kernel_inputs(emap, cvs, rows)
    check(set(inputs) == {(1229, 2 * math.pi), (152 ** 2, float("inf"))},
          f"{tag}: kernel widths {sorted(inputs)}")
    kern = adc_kernel_check(fs, inputs, tag, oracle=True)
    return dict(counts=counts, kernels=kern, wall=wall)


def phase_distributed(em, fs, _build, run_dir: Path, stream: dict, feat: dict) -> dict:
    """Data parallelism on the one card: an NCCL process group of one rank
    (``file://`` rendezvous in the run directory). Config 5's streaming for
    2 chunks with ``mesh_shape={"dp": 1}``, through the gather path, against
    the same superbatches without a mesh: the parameters bit for bit. Then
    ``ShardedFeaturizer`` on the first diUbi trajectory, its CVs against
    ``phase_featurize``'s within ``CV_TOL``. Several ranks are shown on the
    CPU (``tests/test_torch_distributed.py``); time across cards needs a
    machine with more of them."""
    import os

    import torch.distributed as dist

    from encodermap_tpu_torch import parallel
    from encodermap_tpu_torch.parallel.sharded_featurize import ShardedFeaturizer
    from encodermap_tpu_torch.train import autoencoder as ae
    from encodermap_tpu_torch.train.core import tree_leaves

    tag = "distributed"
    smi = smi_line()
    run_dir.mkdir(parents=True, exist_ok=True)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    parallel.initialize(init_method=f"file://{run_dir / 'rendezvous'}", world_size=1, rank=0)
    try:
        check(dist.get_backend() == "nccl", f"{tag}: backend {dist.get_backend()}")
        sbs = stream["superbatches"]
        n = 2 * STREAM_STEPS
        runs, counts = {}, {}
        gathered = []
        plain_gather = ae.gather_rows

        def recording_gather(x, group=None):
            gathered.append((x.numel(), x.requires_grad))
            return plain_gather(x, group)

        for name, mesh in (("one device", None), ("dp=1 mesh", {"dp": 1})):
            ae.gather_rows = recording_gather
            m = em.EncoderMap(em.Parameters(main_path=str(run_dir / name), n_steps=n,
                                            mesh_shape=mesh, **stream["kw"]),
                              stream["proto"], model_params=stream["init"], read_only=True)
            torch.cuda.synchronize()
            _build.launch_counts.clear()
            t0 = time.perf_counter()
            try:
                m.train_streaming(iter(sbs))
            finally:
                ae.gather_rows = plain_gather
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            c = dict(_build.launch_counts)
            check(c.get("sigmoid_fwd") == n and c.get("sigmoid_bwd") == n,
                  f"{tag} {name}: sigmoid kernels launched {c}")
            for k, v in c.items():
                counts[k] = counts.get(k, 0) + v
            runs[name] = (m, wall)
            log(f"[{tag}] {name}: {n} streamed steps, {n * STREAM_B / wall:.0f} samples/s "
                f"({wall:.2f} s, host clock ending in a sync; {smi})")
        check(len(gathered) == 2 * n, f"{tag}: {len(gathered)} gathers in {n} dp steps")
        # what a ring moves per rank and step at N ranks: the all-gathers of
        # the rows (global batch x widths), the reduce-scatter of the rows
        # that carry a gradient, the all-reduce of the parameter gradients
        rows = sum(k for k, _ in gathered) * 4 / n
        grad_rows = sum(k for k, g in gathered if g) * 4 / n
        params = sum(t.numel() for t in tree_leaves(runs["dp=1 mesh"][0].state.params)) * 4
        for N in (2, 4, 8):
            f = (N - 1) / N
            log(f"[{tag}] collective bytes a step per rank at N={N} (ring): all-gather "
                f"{f * rows:.0f}, reduce-scatter {f * grad_rows:.0f}, gradient all-reduce "
                f"{2 * f * params:.0f}, total {f * (rows + grad_rows + 2 * params):.0f} "
                f"(config 5, B={STREAM_B}; read from this run's gathers)")
        same = _same_params(runs["one device"][0], runs["dp=1 mesh"][0])
        log(f"[{tag}] the dp=1 gather path against one device: parameters bit-identical {same}")
        check(same, f"{tag}: the dp=1 mesh's parameters differ from the one-device run's")

        mesh = parallel.make_mesh(dp=1)
        traj = feat["trajs"].trajs[0]
        sharded = ShardedFeaturizer(traj, mesh=mesh)
        sharded.add_list_of_feats("all")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sharded.get_output(ensemble=True)
        torch.cuda.synchronize()
        t_feat = time.perf_counter() - t0
        errs = cv_errors(out, traj._CVs)
        log(f"[{tag}] ShardedFeaturizer, one NCCL rank, {traj.n_frames} diUbi frames: "
            f"{traj.n_frames / t_feat:.0f} frames/s (host clock ending in a sync; {smi}); "
            f"against phase_featurize's CVs: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        check(all(v <= CV_TOL[k] for k, v in errs.items()), f"{tag}: sharded CVs off")
    finally:
        dist.destroy_process_group()
    return dict(counts=counts)


# -------------------------------------------- slice 6c: tensor parallelism
#: the tp leg's EncoderMap: config 1 at full width, B=256, 100 steps
TP_STEPS = 100
TP_EM_KW = dict(n_neurons=[128, 128, 2], batch_size=256, steps_per_scan=TP_STEPS,
                n_steps=TP_STEPS, seed=0, periodicity=float("inf"))
#: two ranks on the one card: dp=1 x tp=2
TP_MESH = {"dp": 1, "tp": 2}


def leaf_arrays(tree) -> list:
    from encodermap_tpu_torch.train.core import tree_leaves

    return [t.detach().cpu().numpy() for t in tree_leaves(tree)]


def _tp_run(em, model, idx: np.ndarray, _build) -> dict:
    """``model``'s state through ``shard_params_tp``, then ``train()`` on
    the injected indices with the launch counts set to 0 just before and
    read just after; the whole parameters and moments, this rank's own
    leaves, the history, the counts, and the tp step's time (the chunk
    trainer again, CUDA-synchronized host clock)."""
    from encodermap_tpu_torch import parallel

    sharded = parallel.shard_params_tp(model.state.params, model.mesh)
    model.state = model.state.replace(params=sharded, opt_state=model.optimizer.init(sharded))
    dev_data = model._device_data()
    steps = idx.shape[0]
    trainer = model._get_trainer(steps)
    trainer(model.state, dev_data, torch.as_tensor(idx[:1], device=model.device))  # warm-up
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    hist = model.train(index_stream=iter([idx]))
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    t0 = time.perf_counter()
    trainer(model.state, dev_data, torch.as_tensor(idx, device=model.device))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    st = model.state
    out = {f"p{i}": a for i, a in enumerate(leaf_arrays(parallel.unshard_params_tp(st.params)))}
    out.update({f"mu{i}": a for i, a in enumerate(
        leaf_arrays(parallel.unshard_params_tp(st.opt_state["mu"])))})
    out.update({f"l{i}": a for i, a in enumerate(leaf_arrays(st.params))})
    out.update({f"h_{k}": np.asarray(v) for k, v in hist.items()})
    out.update({f"count_{k}": np.array(v) for k, v in counts.items()})
    out["ms"] = np.array(ms)
    out["kinds"] = np.array([getattr(l, "kind", "") for l in st.params["encoder"]])
    out["replicated"] = np.array(replicated_leaves(st.params))
    return out


def replicated_leaves(tree) -> list:
    """Per leaf (``tree_leaves`` order): whether every tp rank holds it
    whole (a row-parallel layer's bias does)."""
    from encodermap_tpu_torch.nn import TPLayer

    if isinstance(tree, TPLayer):
        return ["tp" not in tree.specs[k] for k in sorted(tree)]
    if isinstance(tree, dict):
        return [f for k in sorted(tree) for f in replicated_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [f for v in tree for f in replicated_leaves(v)]
    return [True]


def tp_worker(rank: int, run_dir: Path) -> int:
    """One rank of ``phase_tensor_parallel``: joins the two-rank group
    (gloo: both ranks share the one card), builds the trainers with
    ``mesh_shape={"dp": 1, "tp": 2}``, shards their states and trains from
    the parent's weights on its indices; results to ``rank<r>.npz``."""
    import torch.distributed as dist

    import encodermap_tpu_torch as em
    from encodermap_tpu_torch import parallel
    from encodermap_tpu_torch.misc.saving import load_pytree
    from encodermap_tpu_torch.ops import _build

    spec = dict(np.load(run_dir / "spec.npz"))
    parallel.initialize(init_method=f"file://{run_dir / 'rendezvous'}", world_size=2,
                        rank=rank, device="cuda")
    try:
        emap = em.EncoderMap(em.Parameters(main_path=str(run_dir / f"em_rank{rank}"),
                                           mesh_shape=TP_MESH, **json.loads(str(spec["em_kw"]))),
                             spec["em_data"], model_params=load_pytree(run_dir / "em_init.npz"),
                             device="cuda")
        res = {f"em_{k}": v for k, v in _tp_run(em, emap, spec["em_idx"], _build).items()}
        res["backend"] = np.array(dist.get_backend())
        res["mesh"] = np.array([emap.mesh["dp"].size(), emap.mesh["tp"].size()])
        cvs = {k: spec[f"adc_{k}"] for k in CV_KEYS}
        adc = em.AngleDihedralCartesianEncoderMap(
            cvs, adc_params(em, run_dir / f"adc_rank{rank}", 1, 1, mesh_shape=TP_MESH),
            model_params=load_pytree(run_dir / "adc_init.npz"), device="cuda")
        res.update({f"adc_{k}": v for k, v in _tp_run(em, adc, spec["adc_idx"], _build).items()})
        res["allreduce_ms"] = np.array(_allreduce_ms(emap.mesh.get_group("tp")))
        np.savez(run_dir / f"rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()
    return 0


def _one_device_steps(em, model, idx: np.ndarray) -> dict:
    """The reference: the same steps on one device, one step a chunk, with
    each step's gradient read from the Adam first moments (for the
    rounding-noise rule), and its history."""
    moments: list = []

    class Moments(em.Callback):
        def on_chunk_end(self, first_step, metrics):
            moments.append(leaf_arrays(model.state.opt_state["mu"]))

    model.add_callback(Moments())
    hist = model.train(index_stream=iter([i[None] for i in idx]))
    out = {f"p{i}": a for i, a in enumerate(leaf_arrays(model.state.params))}
    out.update({f"mu{i}": a for i, a in enumerate(leaf_arrays(model.state.opt_state["mu"]))})
    out.update({f"h_{k}": np.asarray(v) for k, v in hist.items()})
    prev = [np.zeros_like(m) for m in moments[0]]
    for k, mus in enumerate(moments):
        out.update({f"g{k}_{i}": (m - 0.9 * q) / 0.1 for i, (m, q) in enumerate(zip(mus, prev))})
        prev = mus
    return out


def hold_same_steps(got: dict, want: dict, tag: str, moments: bool = True,
                    steps_from: dict = None, loss_rtol: float = 1e-5, loss_atol: float = 1e-7,
                    lr: float = 1e-3) -> tuple:
    """Every logged term to ``loss_rtol`` relative (``loss_atol``
    absolute), the first moments (the gradients) to 1e-4 of the model's
    largest (unless ``moments`` is False: the caller holds the gradients
    otherwise), every parameter to 1e-5 absolute, with ROADMAP's
    rounding-noise rule for Adam read at each step: a weight whose gradient
    was below 1e-6 of its tensor's largest, or below 100 times Adam's eps
    (1e-5), at some step took a step set by rounding noise there (Adam
    steps by ``lr g / (|g| + eps)``, whose slope there turns a gradient's
    last bits, ~1e-6 on the card's ADC step, into more than 1e-5 of a
    step) and is held to its steps (``lr`` each); the weights this excuses
    (off by more than 1e-5) may be at most 1 % of the model's. Returns
    (worst loss rel, worst moment rel, worst param abs of the others,
    weights excused). The per-step gradients ``g<step>_<leaf>`` come from
    ``steps_from`` (default ``want``), a one-device run of one step a
    chunk (``_one_device_steps``)."""
    steps = len(want["h_loss"])
    worst_loss = 0.0
    for k in (k for k in want if k.startswith("h_")):
        err = np.abs(got[k] - want[k])
        ok = np.all(err <= loss_atol + loss_rtol * np.abs(want[k]))
        worst_loss = max(worst_loss, float((err / np.maximum(np.abs(want[k]), 1e-30)).max()))
        check(bool(ok), f"{tag}: {k} off the one-device run by {float(err.max()):.3e}")
    mus = [k for k in want if k.startswith("mu")]
    scale = max(float(np.abs(want[k]).max()) for k in mus)
    worst_mu = max(float(np.abs(got[k] - want[k]).max()) for k in mus) / scale
    check(not moments or worst_mu <= 1e-4,
          f"{tag}: first moments off by {worst_mu:.3e} of the largest")
    worst_p, flagged, total = 0.0, 0, 0
    for k in (k for k in want if k.startswith("p")):
        grads = [np.abs((steps_from or want)[f"g{s}_{k[1:]}"]) for s in range(steps)]
        noise = np.any([(g < 1e-6 * g.max()) | (g < 1e-5) for g in grads], axis=0)
        err = np.abs(got[k] - want[k])
        flagged, total = flagged + int((noise & (err > 1e-5)).sum()), total + noise.size
        worst_p = max(worst_p, float(err[~noise].max()) if (~noise).any() else 0.0)
        check(bool(np.all(err[~noise] <= 1e-5)), f"{tag}: {k} off by {float(err[~noise].max()):.3e}")
        check(bool(np.all(err[noise] <= 2 * lr * steps)), f"{tag}: {k} noise weights off")
    check(flagged <= 0.01 * total, f"{tag}: {flagged} of {total} weights excused as rounding "
          f"noise")
    return worst_loss, worst_mu, worst_p, flagged


def _allreduce_ms(group, reps: int = 100) -> float:
    """ms of one all-reduce of a 256 x 128 float32 tensor on the card over
    ``group``: the row-parallel layer's partial product at [128,128,2],
    B=256 (CUDA-synchronized host clock, after 5 untimed)."""
    import torch.distributed as dist

    y = torch.randn(256, 128, device="cuda")
    for _ in range(5):
        dist.all_reduce(y, group=group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        dist.all_reduce(y, group=group)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def phase_tensor_parallel(em, fs, _build, run_dir: Path) -> dict:
    """Tensor parallelism on the one card: two processes, a ``dp=1 x
    tp=2`` mesh over a gloo group (NCCL refuses two ranks on one card;
    gloo stages every collective through the host), ``file://``
    rendezvous in the run directory, every tensor on ``cuda:0``. Each rank
    shards the state (``shard_params_tp``) and trains config 1 at full
    width ([128,128,2], cube, B=256) for 100 steps, then one trp-cage ADC
    step (phase_adc's configuration), from this process's weights and
    indices; both are held to the same steps on one device (the general
    route, which the mesh takes too). The checkpoint the sharded run
    writes holds the whole tensors and loads on one device. The ranks'
    launches of the sigmoid kernels come back here. The step time is the
    price of host-staged collectives on a shared card, not a speed for
    tensor parallelism; each rank also times one all-reduce of the
    row-parallel partial product on the ``tp`` group."""
    import os

    from encodermap_tpu_torch.misc.saving import load_checkpoint, load_pytree, save_pytree
    from encodermap_tpu_torch.train.core import tree_leaves

    tag = "tp"
    smi = smi_line()
    run_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(5)
    data = em.create_n_cube(3, points_along_edge=500, seed=0)[0]
    em_idx = rng.integers(0, len(data), (TP_STEPS, TP_EM_KW["batch_size"]))
    cvs = adc_cvs(20, 1024, seed=3)
    adc_idx = rng.integers(0, 1024, (1, 256))
    ref_em = em.EncoderMap(em.Parameters(main_path=str(run_dir / "em_one"), fused_trainer=False,
                                         **dict(TP_EM_KW, steps_per_scan=1)), data)
    ref_adc = em.AngleDihedralCartesianEncoderMap(cvs, adc_params(em, run_dir / "adc_one", 1, 1))
    save_pytree(ref_em.state.params, run_dir / "em_init.npz")
    save_pytree(ref_adc.state.params, run_dir / "adc_init.npz")
    np.savez(run_dir / "spec.npz", em_data=data, em_idx=em_idx, adc_idx=adc_idx,
             em_kw=np.array(json.dumps(TP_EM_KW)),
             **{f"adc_{k}": v for k, v in cvs.items()})
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--tp-worker",
                               str(r), str(run_dir)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for r, proc in enumerate(procs):
            out, _ = proc.communicate(timeout=300)
            outs.append(out)
            check(proc.returncode == 0, f"{tag}: rank {r} failed:\n{out[-3000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    wall = time.perf_counter() - t0
    ranks = [dict(np.load(run_dir / f"rank{r}.npz")) for r in range(2)]
    for r in ranks:
        check(str(r["backend"]) == "gloo" and list(r["mesh"]) == [1, 2],
              f"{tag}: backend {r['backend']}, mesh {r['mesh']}")
        check(list(r["em_kinds"]) == ["column", "row", ""], f"{tag}: layouts {r['em_kinds']}")

    counts: dict = {}
    for pre, per_step, steps in (("em", 1, TP_STEPS), ("adc", 2, 1)):
        for r in ranks:
            c = {k[len(pre) + 7:]: int(v) for k, v in r.items() if k.startswith(f"{pre}_count_")}
            check(c.get("sigmoid_fwd") == per_step * steps
                  and c.get("sigmoid_bwd") == per_step * steps
                  and not c.get("fused_train") and not c.get("fused_train_cluster"),
                  f"{tag} {pre}: a rank launched {c}")
            for k, v in c.items():
                counts[k] = counts.get(k, 0) + v
        a, b = ({k[len(pre) + 1:]: v for k, v in r.items() if k.startswith(pre + "_")}
                for r in ranks)
        for k in a:
            if k[0] == "p" or k.startswith("mu") or k.startswith("h_"):
                check(np.array_equal(a[k], b[k]), f"{tag} {pre}: the ranks' {k} differ")
        rep = a["replicated"]
        check(not rep.all() and all(np.array_equal(a[f"l{i}"], b[f"l{i}"])
                                    for i in np.flatnonzero(rep)),
              f"{tag} {pre}: nothing sharded, or the ranks' replicated leaves differ")

    em_ref = _one_device_steps(em, ref_em, em_idx)
    got = {k[3:]: v for k, v in ranks[0].items() if k.startswith("em_")}
    loss_e, mu_e, par_e, noise = hold_same_steps(got, em_ref, f"{tag} EncoderMap")
    log(f"[{tag}] EncoderMap {TP_EM_KW['n_neurons']} B={TP_EM_KW['batch_size']}, {TP_STEPS} "
        f"tp-sharded steps on two gloo ranks "
        f"against one device: losses within {loss_e:.2e} relative, first moments within "
        f"{mu_e:.2e} of the largest, parameters within "
        f"{par_e:.2e} ({noise} weights off by more, held to their steps by the rounding-noise "
        f"rule); "
        f"replicated leaves bit-identical across the ranks")
    ckpt, _, step = load_checkpoint(run_dir / "em_rank0")
    check(step == TP_STEPS and not (run_dir / "em_rank1" / f"saved_model_{TP_STEPS}.npz").exists(),
          f"{tag}: checkpoint step {step}, or rank 1 wrote one")
    check(all(np.array_equal(x, got[f"p{i}"]) for i, x in enumerate(tree_leaves(ckpt))),
          f"{tag}: the checkpoint is not the gathered parameters")
    one = em.EncoderMap(em.Parameters(**TP_EM_KW), data, model_params=ckpt, read_only=True)
    check(np.isfinite(one.encode(data[:1024])).all(), f"{tag}: the checkpoint encodes NaN")

    adc_ref = _one_device_steps(em, ref_adc, adc_idx)
    got = {k[4:]: v for k, v in ranks[0].items() if k.startswith("adc_")}
    loss_a, mu_a, par_a, noise_a = hold_same_steps(got, adc_ref, f"{tag} ADC", moments=False)
    # the ADC step's float32 gradient is good to ~3e-5 of each tensor's
    # largest (phase_adc's oracle), so the two float32 steps' gradients are
    # held to the float64 oracle at the same weights, by the f64 rule
    from encodermap_tpu_torch.ops.adc_adjoint import hand_adc_step

    init = load_pytree(run_dir / "adc_init.npz")
    f64 = [[torch.tensor(np.asarray(l[n]), dtype=torch.float64, device="cuda")
            for l in init[part]] for part in ("encoder", "decoder") for n in ("kernel", "bias")]
    b = [torch.tensor(cvs[k][adc_idx[0]], dtype=torch.float64, device="cuda") for k in CV_KEYS]
    gew, geb, gdw, gdb, _ = hand_adc_step(
        *f64, b[0], b[1], b[2][:, 1::3], b[3], b[4], 0.0,
        hyper=_oracle_hyper(ref_adc.p, b[2][:, 1::3].shape[1]))
    g64 = [np.clip(g.cpu().numpy(), -1.0, 1.0) for g in tree_leaves(
        {part: [{"bias": bb, "kernel": w} for w, bb in zip(ws, bs)]
         for part, ws, bs in (("encoder", gew, geb), ("decoder", gdw, gdb))})]
    errs = []
    for i, c in enumerate(g64):
        e_tp, e_one = (float(np.abs(g - c).max() / np.abs(c).max())
                       for g in (10 * got[f"mu{i}"], adc_ref[f"g0_{i}"]))
        errs.append((e_tp, e_one))
    check(all(a <= 3 * b for a, b in errs), f"{tag} ADC: the tp step's gradients part from "
          f"float64 more than 3x the one-device step's: {errs}")
    log(f"[{tag}] ADC trp-cage B=256, one tp-sharded step against one device: every logged "
        f"term within {loss_a:.2e} relative, first moments within {mu_a:.2e} of the largest, "
        f"parameters within {par_a:.2e} ({noise_a} weights "
        f"off by more, held to their steps by the rounding-noise rule); gradients against "
        f"hand_adc_step in float64, tp / one device, per tensor: "
        + ", ".join(f"{a:.1e}/{b:.1e}" for a, b in errs))

    # the one-device general route's step for scale, CUDA-synchronized host clock
    warm = em.EncoderMap(em.Parameters(fused_trainer=False, **TP_EM_KW), data,
                         model_params=load_pytree(run_dir / "em_init.npz"), read_only=True)
    trainer, dev_data = warm._get_trainer(), warm._device_data()
    idx = torch.as_tensor(em_idx, device="cuda")
    trainer(warm.state, dev_data, idx[:1])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    trainer(warm.state, dev_data, idx)
    torch.cuda.synchronize()
    ms_one = (time.perf_counter() - t1) * 1e3 / TP_STEPS
    ms_tp = [float(r["em_ms"]) for r in ranks]
    log(f"[{tag}] EncoderMap step on two gloo ranks sharing the card: "
        + ", ".join(f"rank {i} {m:.2f} ms" for i, m in enumerate(ms_tp))
        + f"; one device {ms_one:.2f} ms (general route; host clock with CUDA syncs; {smi}). "
        f"The tp number is the price of host-staged collectives on one shared card, not a "
        f"speed for tensor parallelism. ADC step on the ranks "
        + ", ".join(f"{float(r['adc_ms']):.2f}" for r in ranks)
        + f" ms; one 256x128 float32 all-reduce on the tp group "
        + ", ".join(f"{float(r['allreduce_ms']):.3f}" for r in ranks)
        + f" ms; sigmoid launches on the ranks {counts}; leg {wall:.1f} s for the two processes")
    return dict(counts=counts, ms_tp=ms_tp, ms_one=ms_one)


# ------------------------------------------------- slice 6b: observability
def _crc32c_bitwise(data: bytes) -> int:
    """CRC-32C one bit at a time: this script's own check of the records,
    independent of the package's table-driven code."""
    c = 0xFFFFFFFF
    for b in data:
        c ^= b
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 & -(c & 1))
    return c ^ 0xFFFFFFFF


def _masked(data: bytes) -> int:
    c = _crc32c_bitwise(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _pb_fields(buf: bytes) -> dict:
    """A protobuf message's fields: ``{number: [values]}`` (varints as ints,
    fixed64/fixed32 and length-delimited fields as bytes)."""
    out: dict = {}
    i = 0

    def varint(i):
        n = shift = 0
        while True:
            b = buf[i]
            n |= (b & 0x7F) << shift
            i += 1
            shift += 7
            if not b & 0x80:
                return n, i

    while i < len(buf):
        key, i = varint(i)
        wire = key & 7
        if wire == 0:
            val, i = varint(i)
        elif wire == 1:
            val, i = buf[i:i + 8], i + 8
        elif wire == 2:
            n, i = varint(i)
            val, i = buf[i:i + n], i + n
        elif wire == 5:
            val, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"wire type {wire}")
        out.setdefault(key >> 3, []).append(val)
    return out


def read_events(path) -> tuple:
    """``(scalars, images, n_records)`` of a TensorBoard event file, read
    with this script's own TFRecord and protobuf decoding: scalars
    ``{(tag, step): float32}``, images ``{(tag, step): (width, height)}``.
    Every record's two masked CRC-32Cs are checked; a bad one raises."""
    raw = Path(path).read_bytes()
    scalars, images = {}, {}
    i = n_rec = 0
    while i < len(raw):
        head = raw[i:i + 8]
        (n,) = struct.unpack("<Q", head)
        payload = raw[i + 12:i + 12 + n]
        check(struct.unpack("<I", raw[i + 8:i + 12])[0] == _masked(head)
              and struct.unpack("<I", raw[i + 12 + n:i + 16 + n])[0] == _masked(payload),
              f"{path}: record {n_rec} fails its CRC")
        i += 16 + n
        n_rec += 1
        event = _pb_fields(payload)
        if n_rec == 1:
            check(event.get(3) == [b"brain.Event:2"], f"{path}: no file_version event first")
        step = event.get(2, [0])[0]
        for summary in event.get(5, []):
            for value in _pb_fields(summary).get(1, []):
                v = _pb_fields(value)
                tag, tensor = v[1][0].decode(), _pb_fields(v[8][0])
                if tensor[1][0] == 7:  # DT_STRING: [width, height, png]
                    w, h, png = tensor[8]
                    check(struct.unpack(">II", png[16:24]) == (int(w), int(h)),
                          f"{path}: image {tag} at {step}: size fields disagree with its PNG")
                    images[tag, step] = (int(w), int(h))
                else:
                    scalars[tag, step] = np.frombuffer(tensor[4][0], "<f4")[0]
    return scalars, images, n_rec


def png_gray(img: np.ndarray) -> bytes:
    """An 8-bit greyscale PNG of a 2-D uint8 array, built with zlib and
    struct."""
    h, w = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def latent_histogram_png(latent: torch.Tensor, bins: int = 96) -> bytes:
    """A 2-D histogram of the latent, computed on its device, as a PNG."""
    lo, hi = latent.min(0).values, latent.max(0).values
    cell = ((latent - lo) / (hi - lo + 1e-12) * bins).long().clamp(0, bins - 1)
    counts = torch.bincount(cell[:, 1] * bins + cell[:, 0], minlength=bins * bins)
    img = (255.0 * counts / counts.max()).to(torch.uint8).reshape(bins, bins).flip(0)
    return png_gray(img.cpu().numpy())


def phase_observability(em, fs, _build, run_dir: Path) -> dict:
    """Slice 6b on the card: cube training at BASELINE config 1's width
    ([128,128,2], B=256, the cluster kernel; 1,000 steps in two 500-step
    chunks) with TensorBoard events, the model summary and a user callback
    writing a PNG histogram of the latent computed on the card; the event
    file read back (CRCs, tags and steps and float32 values equal to the
    JSONL rows, image sizes); layer statistics through a writer of their
    own; a 50-step ADC at trp-cage scale with TensorBoard on (the sigmoid
    kernels twice a step); ``profile_steps`` with the cluster kernel named
    in the trace; ``block_timer`` against CUDA events; ``function`` compiled
    on the card. Returns the leg's launch counts."""
    import gzip
    import importlib.util

    from encodermap_tpu_torch.misc import summaries as S
    from encodermap_tpu_torch.misc.profiling import block_timer, profile_steps, trace
    from encodermap_tpu_torch.models import sequential as seq
    from encodermap_tpu_torch.train.core import tree_leaves

    t_leg = time.perf_counter()
    _build.launch_counts.clear()
    data = em.create_n_cube(3, points_along_edge=500, seed=0)[0]
    cube_dir = run_dir / "cube"
    p = em.Parameters(main_path=str(cube_dir), n_neurons=[128, 128, 2], batch_size=256,
                      steps_per_scan=500, n_steps=1000, seed=0, periodicity=float("inf"),
                      tensorboard=True, summary_step=10, write_summary=True)
    emap = em.EncoderMap(p, data)
    sample = torch.as_tensor(data[:8192], device="cuda")

    class LatentHistogram(em.Callback):
        """Writes a PNG of the latent's 2-D histogram at every chunk end."""

        def on_chunk_end(self, first_step, metrics):
            with torch.no_grad():
                png = latent_histogram_png(seq.encode(emap.state.params, emap.p, sample))
            S.write_user_image(png, first_step + len(metrics["loss"]), p.main_path,
                               name="latent_histogram", writer=emap._metrics_writer)

    emap.add_callback(LatentHistogram())
    before = dict(_build.launch_counts)
    t0 = time.perf_counter()
    hist = emap.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    runs = {k: v - before.get(k, 0) for k, v in _build.launch_counts.items()}
    check(runs.get("fused_train_cluster", 0) == 2 and runs.get("fused_train", 0) == 0,
          f"observability: train() launched {runs}, expected the cluster kernel twice")
    check(hist["loss"][-100:].mean() < hist["loss"][:100].mean(),
          "observability: the loss did not fall")

    events = list((cube_dir / "train").glob("events.out.tfevents.*"))
    check(len(events) == 1, f"observability: {len(events)} event files")
    ev_bytes = events[0].stat().st_size
    scalars, images, n_rec = read_events(events[0])
    rows = [json.loads(line) for line in (cube_dir / "train_metrics.jsonl").read_text().splitlines()]
    want = {(k, r["step"]): np.float32(v) for r in rows for k, v in r.items() if k != "step"}
    check(sorted(scalars) == sorted(want) and {s for _, s in want} == set(range(10, 1001, 10)),
          "observability: event tags and steps differ from the JSONL rows")
    check(all(scalars[k].tobytes() == want[k].tobytes() for k in want),
          "observability: event values differ from the JSONL rows as float32")
    size = struct.unpack(">II", latent_histogram_png(seq.encode(
        emap.state.params, emap.p, sample).detach())[16:24])
    check(images == {("latent_histogram", 500): size, ("latent_histogram", 1000): size},
          f"observability: image events {images}")
    n_params = sum(t.numel() for t in tree_leaves(emap.state.params))
    summary = (cube_dir / "complete_model_summary.txt").read_text().splitlines()
    check(summary[-1] == f"Total params: {n_params:,}",
          f"observability: model summary ends {summary[-1]!r}, {n_params:,} parameters")
    log(f"[observability] train() {train_s:.2f} s, 1000 steps; event file {ev_bytes} bytes, "
        f"{n_rec} records, {len(scalars)} scalars equal to the JSONL rows as float32, "
        f"images {images}; model summary: {summary[-1]}")

    # the writer alone: the same 100 rows with and without the event file
    row_ms = {}
    for tb in (False, True):
        w = S.MetricsWriter(run_dir / f"rows_{tb}", tensorboard=tb)
        t0 = time.perf_counter()
        for r in rows:
            w.write_scalars(r["step"], {k: v for k, v in r.items() if k != "step"})
        row_ms[tb] = (time.perf_counter() - t0) * 1e3 / len(rows)
        w.close()
    stats = S.MetricsWriter(run_dir / "stats", tensorboard=True)
    S.add_layer_summaries(stats, 1000, emap.state.params)
    S.histogram_summary(stats, 1000, emap.state.params)
    stats.close()
    got, _, _ = read_events(next((run_dir / "stats" / "train").glob("events.out.tfevents.*")))
    leaves = dict(S.param_paths(emap.state.params))
    check(len(got) == 4 * len(leaves), f"observability: {len(got)} layer statistics")
    for name, leaf in leaves.items():
        arr = leaf.detach().cpu().numpy()
        check(got[f"weights/{name}/mean", 1000] == np.float32(arr.mean())
              and got[f"weights/{name}/std", 1000] == np.float32(arr.std()),
              f"observability: histogram_summary of {name}")
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    try:
        S.image_summary(np.zeros((4, 2), np.float32), 0, run_dir)
        raised = False
    except ImportError:
        raised = True
    check(raised != has_mpl, "observability: image_summary should raise ImportError exactly "
          "where matplotlib is missing")
    log(f"[observability] writer host time per row of {len(rows[0]) - 1} scalars: "
        f"{row_ms[True]:.4f} ms with the event file, {row_ms[False]:.4f} ms JSONL only; "
        f"{len(got)} layer statistics read back; image_summary "
        f"{'raises ImportError (no matplotlib here)' if raised else 'renders (matplotlib here)'}")

    # the ADC at trp-cage scale with TensorBoard on: kernels 2-3 under the writer
    cvs = adc_cvs(20, 4096)
    ap = adc_params(em, run_dir / "adc", 50, 25, tensorboard=True, summary_step=5)
    before = dict(_build.launch_counts)
    adc_train(em, _build, cvs, ap, "observability adc", 2)  # sets the counts to 0
    _build.launch_counts.update(before)
    adc_scalars, _, _ = read_events(next((run_dir / "adc" / "train").glob("events.out.tfevents.*")))
    adc_rows = [json.loads(line) for line in
                (run_dir / "adc" / "train_metrics.jsonl").read_text().splitlines()]
    check(sorted(adc_scalars) == sorted((k, r["step"]) for r in adc_rows for k in r if k != "step")
          and len(adc_rows) == 10, "observability adc: event tags and steps differ from the JSONL")

    # profiling: the cluster kernel in the trace, and the trace's cost on a chunk
    t0 = time.perf_counter()
    logdir = profile_steps(emap, n_steps=2, logdir=run_dir / "profile")
    prof_s = time.perf_counter() - t0
    traces = list(Path(logdir).glob("*.trace.json.gz"))
    check(len(traces) == 1, f"observability: {len(traces)} profiler traces")
    names = [e.get("name", "") for e in json.loads(gzip.decompress(traces[0].read_bytes()))
             ["traceEvents"] if e.get("cat") == "kernel"]
    n_cluster = sum("fused_train_cluster_kernel" in n for n in names)
    check(n_cluster == 2, f"observability: the trace names the cluster kernel {n_cluster} "
          f"times among {len(names)} device kernels")
    trainer, dev_data, state = emap._get_trainer(), emap._device_data(), emap.state

    def chunk():
        nonlocal state
        state, metrics = trainer(state, dev_data)
        torch.cuda.synchronize()

    plain_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        chunk()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    traced_ms = []
    with trace(run_dir / "profile_overhead", device="cuda"):
        for _ in range(2):
            t0 = time.perf_counter()
            chunk()
            traced_ms.append((time.perf_counter() - t0) * 1e3)
    emap.state = state
    log(f"[observability] profile_steps(n_steps=2) {prof_s:.2f} s with the trace's export; "
        f"the trace names fused_train_cluster_kernel {n_cluster} times among {len(names)} "
        f"device kernels; a 500-step chunk {min(plain_ms):.2f} ms without the trace, "
        f"{min(traced_ms):.2f} ms inside it (host clock, after a CUDA sync)")

    x = torch.randn(4096, 4096, device="cuda") / 64.0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with block_timer("block_timer 10 matmuls", sync=x) as out:
        start.record()
        y = x
        for _ in range(10):
            y = y @ x
        end.record()
    dev_ms = start.elapsed_time(end)
    check(out["seconds"] * 1e3 >= 0.95 * dev_ms,
          f"observability: block_timer {out['seconds'] * 1e3:.2f} ms is short of the CUDA "
          f"events' {dev_ms:.2f} ms")

    def f(a, b):
        return torch.tanh(a) * b + a.sum()

    a, b = torch.randn(10000, device="cuda"), torch.randn(10000, device="cuda")
    t0 = time.perf_counter()
    compiled = em.function(f)(a, b)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    plain = em.function(f, debug=True)(a, b)
    err = float((compiled - plain).abs().max())
    # a.sum() in another order: float32 rounding of the sum, ~1e-5 relative
    check(err <= 1e-5 * float(plain.abs().max()),
          f"observability: function() differs from its debug form by {err:.3g}")
    counts = dict(_build.launch_counts)
    leg_s = time.perf_counter() - t_leg
    log(f"[observability] block_timer {out['seconds'] * 1e3:.2f} ms against CUDA events "
        f"{dev_ms:.2f} ms; function() compiled and ran in {compile_s:.2f} s, {err:.2e} from "
        f"its debug form; leg launches {counts}; leg wall {leg_s:.1f} s "
        f"({smi_line()})")
    return dict(counts=counts, wall=leg_s, event_bytes=ev_bytes, row_ms=row_ms,
                chunk_ms=(min(plain_ms), min(traced_ms)))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 2
    import encodermap_tpu_torch as em
    from encodermap_tpu_torch.ops import _build
    from encodermap_tpu_torch.ops import fused_sigmoid as fs
    from encodermap_tpu_torch.ops import fused_train as ft

    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"[device] {kind}, {torch.cuda.device_count()} visible; nvidia-smi: {smi}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase_build(_build)
    sig = phase_sigmoid(fs, _build)
    router = phase_router(fs)
    # B=256: both held, the cluster kernel's shape; B=288: the grid kernel's
    # (GRID_MIN_BATCH), held, the cluster kernel only timed beside it
    fused = {**phase_fused(em, ft, 256, margin=ROUTE_MARGIN_B256),
             **phase_fused(em, ft, 288, hold_both=False)}
    grid = phase_grid(em, ft, _build)

    runs = ROOT / "build" / "chip_smoke_runs"
    runs.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=runs) as tmp:
        trains = [phase_train(em, ft, _build, Path(tmp) / "cube", periodic=False),
                  phase_train(em, ft, _build, Path(tmp) / "dihedral", periodic=True),
                  phase_train(em, ft, _build, Path(tmp) / "cube1024", periodic=False,
                              B=1024)]
        check(trains[2].get("fused_train", 0) > 0,
              "train() at B=1024 did not run the grid kernel")
        launches = {"fused_train_cluster": sum(t.get("fused_train_cluster", 0) for t in trains),
                    "fused_train": sum(t.get("fused_train", 0) for t in trains)
                    + sum(g["launches"] for g in grid.values())}
        # before any other torch.profiler session: on the card machine CUPTI
        # stops recording kernels for the rest of a process after a session
        # of ~300k device operations (PERF.md §7), and this leg's trace must
        # name the cluster kernel
        obs = phase_observability(em, fs, _build, Path(tmp) / "observability")
        log(f"[leg] phase_observability: {obs['wall']:.1f} s wall")
        launches["fused_train_cluster"] += obs["counts"].get("fused_train_cluster", 0)
        general = phase_general(em, _build, Path(tmp) / "general",
                                router[3, 16384][0])
        gen_f64 = phase_general_f64(em, _build)
        gen1024 = general_step(em, 1024)
        for tag, g in (("cube B=1024", gen1024), ("cube B=16384", general["step"])):
            k = grid[tag]
            log(f"[fused vs general {tag}] grid kernel {1e3 * k['ms'] / k['steps']:.2f} us/step; "
                f"general route {1e3 * g['ms']:.2f} us/step (CUDA events), device busy "
                f"{1e3 * g['busy']:.2f} us/step (torch.profiler)")
        adc_legs = []
        for name, phase in (("adc", phase_adc), ("adc158", phase_adc_matrix),
                            ("adc512", phase_adc_analytic),
                            ("adc_sidechains", phase_adc_sidechains),
                            ("adc_multimer", phase_adc_multimer),
                            ("featurize", phase_featurize),
                            ("analysis", phase_analysis),
                            ("streaming", phase_streaming)):
            t0 = time.perf_counter()
            if phase is phase_analysis:
                adc_legs.append(phase(em, fs, _build, Path(tmp) / name, adc_legs[-1]))
            else:
                adc_legs.append(phase(em, fs, _build, Path(tmp) / name))
            log(f"[leg] {phase.__name__}: {time.perf_counter() - t0:.1f} s wall")
        feat, stream = adc_legs[-3], adc_legs[-1]
        t0 = time.perf_counter()
        adc_legs.append(phase_adc_streaming(em, fs, _build, Path(tmp) / "adc_streaming", feat))
        log(f"[leg] phase_adc_streaming: {time.perf_counter() - t0:.1f} s wall")
        t0 = time.perf_counter()
        adc_legs.append(phase_distributed(em, fs, _build, Path(tmp) / "distributed", stream,
                                          feat))
        log(f"[leg] phase_distributed: {time.perf_counter() - t0:.1f} s wall")
        t0 = time.perf_counter()
        adc_legs.append(phase_tensor_parallel(em, fs, _build, Path(tmp) / "tensor_parallel"))
        log(f"[leg] phase_tensor_parallel: {time.perf_counter() - t0:.1f} s wall")
        adc_legs.append(obs)

    main_sig = sig["D=3 euclid"]
    check(all(n > 0 for n in launches.values()), f"fused kernels' main-path launches {launches}")
    # the cluster kernel at the main configuration, B=256 (500-step chunks);
    # the grid kernel at fused B=1024, cube (50-step chunks)
    cube = fused["cube d0=3 B=256"]
    g1024 = grid["cube B=1024"]
    kernels = [
        dict(name="fused_train_cluster", route="cuda",
             source="encodermap_tpu_torch/csrc/fused_train_cluster.cu",
             replaces="encodermap_tpu/ops/pallas_train.py:303",
             launches=launches["fused_train_cluster"],
             max_abs_err=cube["err"]["fused_train_cluster"],
             ms=cube["ms"]["fused_train_cluster"], plain_ms=cube["ms_p"],
             bound_ms=cube["bound"][0], bound_by=cube["bound"][1], library_ms=None),
        dict(name="fused_train", route="cuda",
             source="encodermap_tpu_torch/csrc/fused_train.cu",
             replaces="encodermap_tpu/ops/pallas_train.py:303",
             launches=launches["fused_train"], max_abs_err=g1024["err"],
             ms=g1024["ms"], plain_ms=g1024["ms_p"],
             bound_ms=g1024["bound"][0], bound_by=g1024["bound"][1], library_ms=None),
    ]
    for name, key, line, count in (("sigmoid_fwd", "fwd", 120, "sigmoid_fwd"),
                                   ("sigmoid_bwd", "bwd", 139, "sigmoid_bwd")):
        err, ms, ms_p, b = main_sig[key]
        kernels.append(dict(
            name=name, route="cuda",
            source="encodermap_tpu_torch/csrc/sigmoid_loss.cu",
            replaces=f"encodermap_tpu/ops/pallas_sigmoid.py:{line}",
            launches=general[count] + gen_f64[count]
            + sum(leg["counts"][count] for leg in adc_legs),
            max_abs_err=err, ms=ms, plain_ms=ms_p,
            bound_ms=b[0], bound_by=b[1], library_ms=None))
    # the one-way kernels at trp-cage's longer half, the ADC step's shape
    one_way = adc_legs[0]["one_way"][29]
    for name, key, count in (("one_way_fwd", "fwd", "one_way_fwd"),
                             ("one_way_bwd", "bwd", "one_way_bwd")):
        err, ms, ms_p, b = one_way[key]
        kernels.append(dict(
            name=name, route="cuda",
            source="encodermap_tpu_torch/csrc/backmap_one_way.cu",
            replaces="none: encodermap_tpu/ops/backmap.py:353 _one_way, plain jnp",
            launches=sum(leg["counts"].get(count, 0) for leg in adc_legs),
            max_abs_err=err, ms=ms, plain_ms=ms_p,
            bound_ms=b[0], bound_by=b[1], library_ms=None))
    # the sidechain kernels at trp-cage, B=256, the sidechain cell's shape
    side = next(leg["sidechain"] for leg in adc_legs if "sidechain" in leg)
    for name in ("sidechain_fwd", "sidechain_bwd"):
        err, ms, ms_p, b = side[name[10:]]
        kernels.append(dict(
            name=name, route="cuda",
            source="encodermap_tpu_torch/csrc/backmap_sidechains.cu",
            replaces="none: encodermap_tpu/ops/backmap_sidechains.py backmap_sidechains_fast, "
                     "plain jnp",
            launches=sum(leg.get("counts", {}).get(name, 0) for leg in adc_legs),
            max_abs_err=err, ms=ms, plain_ms=ms_p,
            bound_ms=b[0], bound_by=b[1], library_ms=None))
    # the clip + Adam kernel at the sidechain configuration's 12 leaves
    err, ms, ms_p, ms_l, b = adc_legs[0]["clip_adam"]["adc-sidechains-128-128-2"]
    kernels.append(dict(
        name="clip_adam", route="cuda", source="encodermap_tpu_torch/csrc/clip_adam.cu",
        replaces="none: encodermap_tpu/train/core.py:62-77 optax.chain(clip, adam)",
        launches=general["clip_adam"] + gen_f64["clip_adam"]
        + sum(leg.get("counts", {}).get("clip_adam", 0) for leg in adc_legs),
        max_abs_err=err, ms=ms, plain_ms=ms_p, bound_ms=b[0], bound_by=b[1],
        library_ms=ms_l))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-worker"]:
        # one rank of phase_tensor_parallel, started by it
        sys.exit(tp_worker(int(sys.argv[2]), Path(sys.argv[3])))
    sys.exit(main())
