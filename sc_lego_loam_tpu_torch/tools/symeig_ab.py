"""Time another build of the symeig C entry beside this checkout's, on one
card, in turns.

    python -m sc_lego_loam_tpu_torch.tools.symeig_ab OTHER.cu [OTHER.cu ...]

Each OTHER.cu is a source with the same ``symeig_launch`` C entry (for
example an earlier ``csrc/symeig.cu``), built alone into a library of its
own.  At n = 3, 4, 6 and B = 1, 3, 16 (random SPD matrices, condition
numbers up to 1e3) and on 4096 6x6 matrices with condition numbers up to
1e8, both builds run on the same inputs into preallocated outputs.  Each
is timed as device ms of one call in a replayed CUDA graph of 20 calls, in
the order other, this, this, other.  The eigenvalues of the two builds are
held within 1e-5 of max|lambda| of each other.  Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

from ..ops import cuda_knn
from .bench import card_line
from .knn_tune import graph_ms, ptxas_lines

REPS = 20
TOL = 1e-5
SHAPES = [(n, B, 1e3) for n in (3, 4, 6) for B in (1, 3, 16)] + [
    (6, 4096, 1e8)]


def spd_batch(rng, B, n, cond_max):
    """B random symmetric positive definite n x n float32 matrices: random
    orthonormal eigenvectors, eigenvalues spread over a condition number
    log-uniform in [1, cond_max] (both ends taken), scales 1e-2 .. 1e4."""
    Q, _ = np.linalg.qr(rng.normal(size=(B, n, n)))
    cond = 10.0 ** rng.uniform(0, np.log10(cond_max), B)
    scale = 10.0 ** rng.uniform(-2, 4, B)
    t = rng.random((B, n))
    t[:, 0], t[:, 1] = 0.0, 1.0
    evals = scale[:, None] * cond[:, None] ** -t
    A = (Q * evals[:, None, :]) @ Q.transpose(0, 2, 1)
    return ((A + A.transpose(0, 2, 1)) / 2).astype(np.float32)


def build_other(source):
    """``source`` built alone with the library's flags, and loaded."""
    os.makedirs(cuda_knn.BUILD_DIR, exist_ok=True)
    out = os.path.join(cuda_knn.BUILD_DIR, "libsymeig_ab_"
                       + os.path.basename(source).replace(".", "_") + ".so")
    proc = subprocess.run([cuda_knn._nvcc(), *cuda_knn.NVCC_FLAGS, "-o", out,
                           source], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {source}:\n{proc.stdout}{proc.stderr}")
    for name, regs, stores, loads in ptxas_lines(proc.stdout + proc.stderr):
        print(f"  ptxas: {name}: {regs} registers, spill stores {stores} "
              f"bytes, spill loads {loads} bytes", flush=True)
    lib = ctypes.CDLL(out)
    lib.symeig_launch.argtypes = cuda_knn._lib.symeig_launch.argtypes
    lib.symeig_launch.restype = ctypes.c_int
    return lib


def compare(source, other, card):
    """Every shape, in turns; False if the eigenvalues differ."""
    ok = True
    rng = np.random.default_rng(21)
    for n, B, cond in SHAPES:
        A = torch.from_numpy(spd_batch(rng, B, n, cond)).cuda()
        outs = {lib: (torch.empty(B, n, device="cuda"),
                      torch.empty(B, n, n, device="cuda"))
                for lib in (other, cuda_knn._lib)}

        def call(lib):
            w, V = outs[lib]
            err = lib.symeig_launch(A.data_ptr(), w.data_ptr(), V.data_ptr(),
                                    None, B, n,
                                    torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"symeig launch failed: {err}")

        ms = [graph_ms(lambda: call(lib), REPS)
              for lib in (other, cuda_knn._lib, cuda_knn._lib, other)]
        w_o, w_n = outs[other][0].cpu(), outs[cuda_knn._lib][0].cpu()
        diff = float(((w_o - w_n).abs().max(1).values
                      / w_o.abs().max(1).values).max())
        ok &= diff <= TOL
        print(f"symeig A/B {os.path.basename(source)} n={n} B={B}: other ms "
              f"{ms[0]:.5f} {ms[3]:.5f}, this ms {ms[1]:.5f} {ms[2]:.5f}, "
              f"ratio other/this {(ms[0] + ms[3]) / (ms[1] + ms[2]):.3f}; "
              f"eigenvalues apart {diff:.2e} (x max|lambda|, tol {TOL}) "
              f"[{card}]", flush=True)
    return ok


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("sources", nargs="+", metavar="OTHER.cu")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = card_line("cuda")
    info = cuda_knn.build()
    print(f"build: {info.path} in {info.seconds:.2f} s [{card}]", flush=True)
    ok = all([compare(source, build_other(source), card)
              for source in args.sources])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
