"""The eval CLI's metrics against the reference's published numbers (the
port's copy of ``tools/check_quality_parity.py``, flag for flag).

The reference's results table (reference readme.md:148-156; ImageNet-1K
validation, 256x256, codebook 1024):

    run      usage%   perplexity   L2(mse)   SSIM   PSNR    rFID
    gumbel   99.61    892.00       0.0075    0.61   21.23   6.30
    entropy  99.70    896.78       0.0082    0.62   20.82   6.17

``parse_metrics`` reads the ``k: v`` lines ``cli/evaluate.py`` prints and
``check`` holds each against the published value within ``TOLERANCES``
(the JAX tool's, whose docstring gives their reasons). It is the last stage
of ``cli/quality_parity.py``. The port may not import ``tools``, so the
table, tolerances and parser are copied here, as ``config.py`` copies the
JAX package's parser; a test holds them equal to the tool's.

    python -m vqvae_tpu_torch.cli.evaluate ... | tee metrics.txt
    python -m vqvae_tpu_torch.eval.quality_parity --run gumbel --metrics metrics.txt

Exit 0 when every metric is within tolerance, 1 otherwise (or when the
file holds no metric line). ``main(argv)`` runs in process and returns
the exit code.
"""

from __future__ import annotations

import argparse
import re
import sys

PUBLISHED = {
    # reference readme.md:152-153
    "gumbel": {"used_codebook": 99.61, "perplexity": 892.00, "mse": 0.0075,
               "ssim": 0.61, "psnr": 21.23, "rfid": 6.30},
    "entropy": {"used_codebook": 99.70, "perplexity": 896.78, "mse": 0.0082,
                "ssim": 0.62, "psnr": 20.82, "rfid": 6.17},
}

# (kind, tol): kind 'rel' = |got-want|/want <= tol, 'abs' = |got-want| <= tol
TOLERANCES = {
    "rfid": ("rel", 0.08),
    "used_codebook": ("abs", 0.5),
    "perplexity": ("rel", 0.03),
    "mse": ("rel", 0.08),
    "ssim": ("abs", 0.02),
    "psnr": ("abs", 0.3),
}


def parse_metrics(text: str) -> dict:
    """Extract the ``key: float`` lines the eval CLI prints (cli/evaluate.py)."""
    out = {}
    for line in text.splitlines():
        m = re.match(r"^\s*(mse|psnr|ssim|used_codebook|perplexity|rfid)\s*:"
                     r"\s*([-+0-9.eE]+)\s*$", line)
        if m:
            out[m.group(1)] = float(m.group(2))
    return out


def check(run: str, metrics: dict, require_rfid: bool = True) -> list:
    """Return a list of failure strings (empty = parity holds)."""
    failures = []
    for key, want in PUBLISHED[run].items():
        if key not in metrics:
            if key == "rfid" and not require_rfid:
                continue
            failures.append(f"{key}: MISSING from evaluate output "
                            f"(published {want})")
            continue
        got = metrics[key]
        kind, tol = TOLERANCES[key]
        err = abs(got - want) / want if kind == "rel" else abs(got - want)
        ok = err <= tol
        mark = "ok" if ok else "FAIL"
        print(f"[{mark}] {key}: got {got:.4f}, published {want:.4f} "
              f"({kind} err {err:.4f}, tol {tol})")
        if not ok:
            failures.append(f"{key}: {got:.4f} vs published {want:.4f} "
                            f"({kind} err {err:.4f} > tol {tol})")
    return failures


def report(run: str, failures: list) -> None:
    """The verdict lines of the JAX tool: the failures on stderr, or OK."""
    if failures:
        print(f"\nQUALITY PARITY FAILED ({run}):", file=sys.stderr)
        for f in failures:
            print(f"  - {f}", file=sys.stderr)
    else:
        print(f"\nQUALITY PARITY OK ({run}) vs reference readme.md:148-156")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--run", choices=sorted(PUBLISHED), required=True)
    p.add_argument("--metrics", type=str, required=True,
                   help="file holding the eval CLI's stdout ('-' = stdin)")
    p.add_argument("--allow_missing_rfid", action="store_true",
                   help="for smoke/dry runs without converted inception "
                        "weights only — a real parity run must include rFID")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.metrics == "-":
        text = sys.stdin.read()
    else:
        with open(args.metrics) as f:
            text = f.read()
    metrics = parse_metrics(text)
    if not metrics:
        print(f"no metric lines found in {args.metrics}", file=sys.stderr)
        return 1
    failures = check(args.run, metrics, require_rfid=not args.allow_missing_rfid)
    report(args.run, failures)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
