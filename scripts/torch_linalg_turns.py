#!/usr/bin/env python3
"""The small-SVD kernels of csrc/linalg.cu timed in turns against an earlier
tree's, on one CUDA device (needs nvcc), at the shapes the RANSAC cores give
them.

    mkdir -p _parent && git archive <commit> | tar -x -C _parent
    python3 scripts/torch_linalg_turns.py --parent _parent [--reps 20] \
        [--out FILE]

Each tree's kernels are called through the interface its own sources give:
the C signatures of hg_null_vector and hg_svd3 read from its
hessgpu_tpu_torch/csrc/linalg.cu, and the values of their arguments (the
sweep cap or fixed sweep count, a tolerance where the signature has one,
the rank tolerance, the Gram slices) from its hessgpu_tpu_torch/ops/
linalg.py, loaded on its own. A pointer named `sweeps` is the sweeps-run
output; an int named `sweeps` or `max_sweeps` takes the tree's
NULL_VECTOR_SWEEPS / SVD3_SWEEPS. Both libraries are built with the
package's nvcc flags (ops/cuda/build.py) under hessgpu_tpu_torch/build/, in
parallel. Inputs: chip_smoke.py's ransac_systems(11) and svd3_systems(12).
At each shape the order of the turns is earlier, this, this, earlier; each
turn is the median of --reps launches by chip_smoke.py's device_timer
(CUDA events, L2 evicted, the card kept busy while the launch is
enqueued). This tree's results are held to its plain versions (bit for bit,
sweeps run included), the earlier tree's null vectors to this tree's (|cos|
where the gap sigma_{n-1} / sigma_1 >= 1e-3) and its 3 x 3 SVDs' singular
values to this tree's. Prints one JSON line a shape and a last JSON line
with the card (also to --out), and exits 1 on a disagreement.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

C_TYPES = {"float*": ctypes.c_void_p, "int*": ctypes.c_void_p,
           "void*": ctypes.c_void_p, "int": ctypes.c_int,
           "double": ctypes.c_double}


def signature(src: str, name: str):
    """[(C type, parameter name)] of the extern function `name` in src."""
    m = re.search(rf"\bint\s+{name}\s*\(([^)]*)\)\s*{{", src)
    if not m:
        raise RuntimeError(f"no {name} in the source")
    params = []
    for p in m.group(1).split(","):
        words = p.replace("const", "").replace("*", " * ").split()
        params.append(("".join(words[:-1]), words[-1]))
    return params


class Tree:
    """One tree's kernels, bound through its own interface."""

    def __init__(self, label: str, root: Path):
        self.label, self.root = label, root
        spec = importlib.util.spec_from_file_location(
            f"linalg_{label}", root / "hessgpu_tpu_torch/ops/linalg.py")
        self.linalg = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(self.linalg)
        self.src = root / "hessgpu_tpu_torch/csrc/linalg.cu"

    def build(self):
        from hessgpu_tpu_torch.ops.cuda import build
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = build.BUILD_DIR / f"turns_{self.label}_{os.getpid()}.so"
        res = subprocess.run(
            [build._find_nvcc(), *build.NVCC_FLAGS, "-shared", str(self.src),
             "-o", str(out)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.src}:\n{res.stdout}")
        lib, text = ctypes.CDLL(str(out)), self.src.read_text()
        self.fns = {}
        for name in ("hg_null_vector", "hg_svd3"):
            params = signature(text, name)
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [C_TYPES[t] for t, _ in params]
            self.fns[name] = (fn, params)
        return self

    def has_sweeps_output(self, name: str) -> bool:
        return ("int*", "sweeps") in self.fns[name][1]

    def call(self, name: str, cap: int, **values):
        """Launches `name` with its parameters taken by name from values
        (tensors as pointers), the cap, and this tree's constants."""
        import torch
        L = self.linalg
        tol = getattr(L, "JACOBI_TOL", None)
        consts = {"max_sweeps": cap, "rank_tol": L.SVD3_RANK_TOL,
                  "tol": tol if tol is not None else getattr(
                      L, "NULL_VECTOR_TOL" if "null" in name else "SVD3_TOL",
                      None),
                  "stream": torch.cuda.current_stream().cuda_stream}
        fn, params = self.fns[name]
        args = []
        for ctype, pname in params:
            if pname == "sweeps" and ctype == "int":
                v = cap                        # a fixed sweep count
            elif pname in values:
                v = values[pname]
            elif pname in consts and consts[pname] is not None:
                v = consts[pname]
            else:
                raise RuntimeError(f"{self.label} {name}: no value for "
                                   f"{ctype} {pname}")
            if isinstance(v, torch.Tensor):
                v = v.data_ptr()
            args.append(0 if v is None else v)
        err = fn(*args)
        if err:
            raise RuntimeError(f"{self.label} {name}: CUDA error {err}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="the root of an unpacked earlier tree")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, help="also write the lines here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_linalg_turns: no CUDA device")
    from chip_smoke import device_timer, ransac_systems, svd3_systems
    from hessgpu_tpu_torch.ops import linalg

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True
    ).stdout.strip()
    with ThreadPoolExecutor(2) as pool:
        trees = dict(zip(("parent", "this"), pool.map(
            Tree.build, (Tree("parent", args.parent), Tree("this", REPO)))))
    timer = device_timer(dev)

    def turns(fn):
        """(parent, this, this, parent) medians of fn(tree)."""
        return [timer(lambda: fn(trees[t]), reps=args.reps)
                for t in ("parent", "this", "this", "parent")]

    def sweeps_of(tree, name, A, run):
        """The sweeps run (B,) of `run`, or the tree's fixed count."""
        if tree.has_sweeps_output(name):
            sweeps = torch.zeros(A.shape[:-2], dtype=torch.int32, device=dev)
            run(sweeps)
            return sweeps
        run(None)
        cap = tree.linalg.NULL_VECTOR_SWEEPS if "null" in name \
            else tree.linalg.SVD3_SWEEPS
        return torch.full(A.shape[:-2], cap, dtype=torch.int32, device=dev)

    def stats(sweeps):
        s = sweeps.double()
        return {"min": int(s.min()), "max": int(s.max()),
                "mean": float(s.mean())}

    lines, ok = [], True

    def emit(rec):
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    for name, A in ransac_systems(11).items():
        A = A.to(dev).contiguous()
        M, n = A.shape[-2:]
        m = n + (n & 1)
        B = A[..., 0, 0].numel()
        outs = {t: torch.empty(A.shape[:-2] + (n,), device=dev)
                for t in trees}

        def null_vector(tree, sweeps=None):
            tree.call("hg_null_vector", tree.linalg.NULL_VECTOR_SWEEPS,
                      A=A, out=outs[tree.label], sweeps=sweeps, B=B, M=M,
                      n=n, slices=tree.linalg.gram_slices(M, n))

        ran = {t: sweeps_of(tree, "hg_null_vector", A,
                            lambda s, tree=tree: null_vector(tree, s))
               for t, tree in trees.items()}
        want, counts = linalg.null_vector_plain(A, return_counts=True)
        equal = torch.equal(outs["this"], want) and \
            torch.equal(ran["this"], counts.sweeps)
        sv = torch.linalg.svd(A.double(), full_matrices=True).S
        gap = (sv[..., -2] if M >= n else sv[..., -1]) \
            / sv[..., 0].clamp_min(1e-300)
        det = gap >= 1e-3
        cos = (outs["this"].double() * outs["parent"].double()).sum(-1).abs()
        cos_min = float(cos[det].min()) if bool(det.any()) else None
        ok &= equal and (cos_min is None or cos_min >= 1 - 1e-5)
        rec = dict(kernel="null_vector", shape=name, equal_to_plain=equal,
                   sweeps={t: stats(s) for t, s in ran.items()},
                   min_cos_parent_vs_this=cos_min)
        if not name.startswith("degenerate"):
            ms = turns(null_vector)
            rounds = {t: int(s.max()) * (m - 1) for t, s in ran.items()}
            rec.update(
                ms_turns=dict(zip(("parent_1", "this_1", "this_2",
                                   "parent_2"), ms)),
                rounds_slowest_matrix=rounds,
                us_per_round={"parent": (ms[0] + ms[3]) / 2 * 1e3
                              / rounds["parent"],
                              "this": (ms[1] + ms[2]) / 2 * 1e3
                              / rounds["this"]})
        emit(rec)

    for name, A in svd3_systems(12).items():
        A = A.to(dev).contiguous()
        B = A[..., 0, 0].numel()
        outs = {t: tuple(torch.empty(A.shape[:-2] + s, device=dev)
                         for s in ((3, 3), (3,), (3, 3)))
                for t in trees}

        def svd3(tree, sweeps=None):
            U, S, Vh = outs[tree.label]
            tree.call("hg_svd3", tree.linalg.SVD3_SWEEPS, A=A, U=U, S=S,
                      Vh=Vh, sweeps=sweeps, B=B)

        ran = {t: sweeps_of(tree, "hg_svd3", A,
                            lambda s, tree=tree: svd3(tree, s))
               for t, tree in trees.items()}
        *want, counts = linalg.svd3_plain(A, return_counts=True)
        equal = all(torch.equal(g, w) for g, w in zip(outs["this"], want)) \
            and torch.equal(ran["this"], counts.sweeps)
        s_err = float((outs["this"][1] - outs["parent"][1]).abs().max())
        ok &= equal and s_err <= 1e-5 * max(1.0, float(
            outs["this"][1].abs().max()))
        rec = dict(kernel="svd3", shape=name, equal_to_plain=equal,
                   sweeps={t: stats(s) for t, s in ran.items()},
                   max_abs_s_parent_vs_this=s_err)
        if not name.startswith("degenerate"):
            ms = turns(svd3)
            rec.update(ms_turns=dict(zip(("parent_1", "this_1", "this_2",
                                          "parent_2"), ms)))
        emit(rec)

    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "reps": args.reps, "ok": ok})
    if args.out:
        args.out.write_text("".join(json.dumps(r) + "\n" for r in lines))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
