"""Run the port's JAX-comparing CPU tests under three instruction-set settings.

A parity test that holds the port against the JAX package must give the same verdict
on any x86 host. The host's instruction set changes the rounding of both packages
(XLA's and ATen's vector code), so this script runs the same files three times, each
setting acting only on the child pytest processes:

- ``default``: the host as it is;
- ``avx2``: ``XLA_FLAGS=--xla_cpu_max_isa=AVX2 ATEN_CPU_CAPABILITY=avx2``;
- ``sse42``: ``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2 ATEN_CPU_CAPABILITY=default``.

Every setting also sets ``UTT_NO_COMPILE_CACHE=1``, so that no XLA program cached under
another setting is reused. The files are the ``tests/test_torch_*.py`` that import JAX or
the JAX package. Run it from the root of the repo:

    python tests/parity_audit.py [--out DIR]

It runs pytest as the repository's Tier-1 command does (6 workers, ``--dist loadfile``),
prints one line per setting (passed, failed, errors, skipped, seconds) and each failing
case with the first line of its message, writes ``DIR/<setting>.xml`` (pytest's junit
report), ``DIR/<setting>.log`` and ``DIR/summary.json``, and exits 1 when any case failed
in any setting.
"""
import argparse
import json
import os
import pathlib
import re
import subprocess
import sys
import time
import xml.etree.ElementTree as ET

ROOT = pathlib.Path(__file__).resolve().parent.parent
SETTINGS = {
    "default": {},
    "avx2": {"XLA_FLAGS": "--xla_cpu_max_isa=AVX2", "ATEN_CPU_CAPABILITY": "avx2"},
    "sse42": {"XLA_FLAGS": "--xla_cpu_max_isa=SSE4_2", "ATEN_CPU_CAPABILITY": "default"},
}
IMPORTS_JAX = re.compile(r"^\s*(import|from)\s+(jax|upliftingtabletennis_tpu)\b", re.M)


def jax_comparing_files():
    """The port's test files that import JAX or the JAX package, sorted."""
    files = sorted((ROOT / "tests").glob("test_torch_*.py"))
    return [str(f.relative_to(ROOT)) for f in files if IMPORTS_JAX.search(f.read_text())]


def setting_env(name):
    env = dict(os.environ, JAX_PLATFORMS="cpu", ALLOW_MULTIPLE_LIBTPU_LOAD="1",
               UTT_NO_COMPILE_CACHE="1")
    env.pop("ATEN_CPU_CAPABILITY", None)
    for key, value in SETTINGS[name].items():
        env[key] = f"{env[key]} {value}" if key == "XLA_FLAGS" and env.get(key) else value
    return env


def read_junit(path):
    """(counts, failures) of a junit report: failures as (case id, first message line)."""
    counts = {"passed": 0, "failed": 0, "errors": 0, "skipped": 0}
    failures = []
    for case in ET.parse(path).getroot().iter("testcase"):
        name = f"{case.get('classname', '').replace('.', '/')}.py::{case.get('name')}"
        bad = case.find("failure")
        bad = bad if bad is not None else case.find("error")
        if bad is not None:
            counts["failed" if bad.tag == "failure" else "errors"] += 1
            message = (bad.get("message") or bad.text or "").strip().splitlines()
            failures.append((name, message[0][:300] if message else ""))
        elif case.find("skipped") is not None:
            counts["skipped"] += 1
        else:
            counts["passed"] += 1
    return counts, failures


def run_setting(name, files, out):
    xml = out / f"{name}.xml"
    cmd = [sys.executable, "-m", "pytest", *files, "-q", "-m", "not slow", "-p",
           "no:cacheprovider", "-p", "no:randomly", "-p", "xdist", "-n", "6", "--dist",
           "loadfile", f"--junitxml={xml}"]
    start = time.time()
    with open(out / f"{name}.log", "w") as log:
        rc = subprocess.call(cmd, cwd=ROOT, env=setting_env(name), stdout=log,
                             stderr=subprocess.STDOUT)
    seconds = round(time.time() - start, 1)
    counts, failures = read_junit(xml) if xml.exists() else ({}, [])
    return {"setting": name, "env": SETTINGS[name], "rc": rc, "seconds": seconds,
            **counts, "failures": failures}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="build/parity_audit")
    args = parser.parse_args(argv)
    files = jax_comparing_files()
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print(f"[audit] {len(files)} files", flush=True)
    results = []
    for name in SETTINGS:
        result = run_setting(name, files, out)
        results.append(result)
        print(f"[audit] {name}: rc={result['rc']} passed={result.get('passed')} "
              f"failed={result.get('failed')} errors={result.get('errors')} "
              f"skipped={result.get('skipped')} seconds={result['seconds']}", flush=True)
        for case, message in result["failures"]:
            print(f"[audit]   {name} FAILED {case}: {message}", flush=True)
    (out / "summary.json").write_text(json.dumps({"files": files, "results": results}, indent=1))
    bad = any(r["rc"] != 0 or r["failures"] for r in results)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
