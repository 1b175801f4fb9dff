"""Build variants of ``csrc/segment_spmm.cu``, swap each into the wrapper,
hold it to the CPU and time DiDiC's products at ``scale=1.0``, in turns, on
one card.

    python3 spmm_variants.py VARIANTS.json [--parent DIR] [--hub-clock]

``VARIANTS.json`` maps a variant's name to a list of ``[old, new]`` text
substitutions made in a copy of the source (``{"base": []}`` is the source
as it stands; ``{"min6": [["kShortMinBlocks = 5;", "kShortMinBlocks =
6;"]]}`` a constant changed). Each variant is built by ``nvcc`` with the
kernels' flags into ``build/spmm_variants/<name>/`` (all builds started
together; each one's registers and spills by instantiation are printed),
then bound in place of the wrapper's library. With ``--parent DIR`` (another
checkout, e.g. the parent commit unpacked with ``git archive`` into a
git-ignored directory) a variant ``parent`` runs that checkout's source
through that checkout's wrapper and matrix. The variants run in turns
(v1, v2, ..., v2, v1); each turn times, on filesystem, GIS and Twitter
(k = 4, ``x`` from seed 5) and on Twitter's 47,691-edge hub alone, the bare
product and the secondary step (fused; the parent's eager updates around
its product) back to back (``b2b``: a call's share of 10, median of 10) and
their device time a call by ``torch.profiler`` (``dev``: the
``segment_spmm`` kernels only, so the parent's eager updates are not in
its ``secondary_dev``), and checks the bare product against the plain
version on the CPU bit for bit (``ok``; a diagnostic variant that skips
work reads false). ``--hub-clock`` first runs the hub alone back to back
for 3 s while ``nvidia-smi`` samples the SM clock, and prints the cycles an
edge at the median clock beside the chain floor (the add's latency, by
``segment_sum``'s probe).

Prints the card's name and power limit and one JSON line ``VARIANTS
{...}``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.core import didic  # noqa: E402
from repro_torch.graphs import datasets  # noqa: E402
from repro_torch.kernels.segment_spmm import csr_matrix, ops, segment_spmm, segment_spmm_secondary  # noqa: E402
from repro_torch.kernels.segment_sum.ops import add_cycles  # noqa: E402

OUT = ROOT / "build" / "spmm_variants"


def build(variants: dict, parent) -> dict:
    """Every variant's library, built together; {name: {instantiation:
    [spill bytes, registers]}}."""
    jobs = {}
    for name, subs in variants.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        src = (pathlib.Path(parent) if name == "parent" else ROOT) / "src" / "repro_torch" / "csrc"
        text = (src / "segment_spmm.cu").read_text()
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"spmm_variants: {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        (d / "segment_spmm.cu").write_text(text)
        (d / "hopper.cuh").write_text((src / "hopper.cuh").read_text())
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "segment_spmm.cu")]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    regs = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"spmm_variants: {name} failed to build:\n{log}")
        cur, regs[name] = None, {}
        for line in log.splitlines():
            m = re.search(r"segment_spmm_kernelI(\w+?)E+vNS_4ArgsE", line)
            if "Compiling entry" in line and m:
                cur = m.group(1)
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and cur:
                regs[name][cur] = [int(m.group(1))]
            m = re.search(r"Used (\d+) registers", line)
            if m and cur:
                regs[name][cur].append(int(m.group(1)))
    return regs


def bind(kernel, name: str) -> None:
    lib = ctypes.CDLL(str(OUT / name / "lib.so"))
    fn = lib.segment_spmm_launch
    fn.argtypes = kernel.argtypes
    fn.restype = ctypes.c_int
    kernel._lib, kernel._fn = lib, fn


def time_cuda(fn, inner=10, reps=10, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def device_ms(fn, calls=10) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "segment_spmm" in e.key) / 1e3 / calls


def hub_clock(x, hub) -> None:
    """The hub alone back to back for 3 s, the SM clock sampled beside it."""
    for _ in range(20):
        segment_spmm(x, hub)
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
                            "-lms", "100"], stdout=subprocess.PIPE, text=True)
    time.sleep(0.5)
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    calls, t0 = 0, time.perf_counter()
    ev0.record()
    while time.perf_counter() - t0 < 3.0:
        for _ in range(100):
            segment_spmm(x, hub)
        calls += 100
        torch.cuda.synchronize()
    ev1.record()
    ev1.synchronize()
    time.sleep(0.3)
    smi.terminate()
    mhz = statistics.median(float(line.split(",")[0]) for line in smi.communicate()[0].splitlines() if line.strip())
    ms = ev0.elapsed_time(ev1) / calls
    edges = hub.col.numel()
    cycles, _ = add_cycles(x.device)
    print(f"hub alone ({edges:,} edges): {ms:.4f} ms a call over {calls:,} calls back to back, SM clock (median of "
          f"the samples) {mhz:.0f} MHz: {ms * 1e-3 * mhz * 1e6 / edges:.3f} cycles an edge; one dependent add "
          f"{cycles:.3f} cycles, chain floor {edges * cycles / (mhz * 1e6) * 1e3:.4f} ms", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", help="JSON file: {name: [[old, new], ...]}")
    ap.add_argument("--parent", help="root of another checkout, run as the variant 'parent'")
    ap.add_argument("--hub-clock", action="store_true", help="sample the SM clock under the hub alone first")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("spmm_variants: needs a CUDA device")
    variants = json.loads(pathlib.Path(args.variants).read_text())
    if args.parent:
        variants = {"parent": [], **variants}
    print(json.dumps({"registers": build(variants, args.parent)}), flush=True)
    dev = torch.device("cuda")
    this_kernel, pops = ops.KERNEL, None
    if args.parent:  # the parent's wrapper, bound to the parent's library
        spec = importlib.util.spec_from_file_location(
            "parent_spmm_ops", pathlib.Path(args.parent) / "src/repro_torch/kernels/segment_spmm/ops.py")
        pops = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(pops)
        kernels.KERNELS["segment_spmm"] = this_kernel
    rng = np.random.default_rng(5)
    cases = {}
    for name in ("filesystem", "gis", "twitter"):
        g = datasets.load(name, scale=1.0, seed=0)
        s, r, ce, degc = didic._edge_coefficients(g)
        sp = didic.SegmentSpmm(s, r, ce, g.n_nodes, dev)
        x, l = (torch.as_tensor(rng.standard_normal((g.n_nodes, 4)).astype(np.float32), device=dev) for _ in range(2))
        parts = torch.as_tensor(rng.integers(0, 4, g.n_nodes).astype(np.int32), device=dev)
        benefit = 1.0 + 9.0 * (parts[:, None] == torch.arange(4, device=dev, dtype=torch.int32)[None, :]).float()
        want = segment_spmm(x.cpu(), sp.a._replace(ids=sp.a.ids.cpu(), col=sp.a.col.cpu(), scale=sp.a.scale.cpu()))
        pa = None if pops is None else pops.csr_matrix(*(torch.as_tensor(t, device=dev) for t in (s, r, ce)), g.n_nodes)
        cases[name] = (sp.a, pa, x, l, parts, torch.as_tensor(degc, device=dev), benefit, want)
        print(f"{name}: {sp.a.long_ids.numel():,} long rows, {sp.a.tiles.shape[0]:,} tiles of at most "
              f"{sp.a.tile_edges:,} edges", flush=True)
    a, pa, x = cases["twitter"][:3]
    off = a.offsets.long()
    row = int(torch.argmax(off[1:] - off[:-1]))
    b, e = int(off[row]), int(off[row + 1])
    hub = csr_matrix(torch.zeros(e - b, dtype=torch.int64, device=dev), a.col[b:e], a.scale[b:e], 1)
    hub_p = None if pops is None else pops.csr_matrix(hub.ids, hub.col, hub.scale, 1)
    hub_want = segment_spmm(x.cpu(), hub._replace(ids=hub.ids.cpu(), col=hub.col.cpu(), scale=hub.scale.cpu()))
    if args.hub_clock:
        hub_clock(x, hub)
    results = {}
    for vname in list(variants) + list(variants)[::-1]:
        parent = vname == "parent"
        bind(pops.KERNEL if parent else this_kernel, vname)
        rec = {}
        for name, (a, pa, x, l, parts, degc, benefit, want) in cases.items():
            if parent:
                bare = lambda: pops.segment_spmm(x, pa)  # noqa: E731
                sec = lambda: (lambda l2: (l2, l2 / benefit))(l - degc[:, None] * x + pops.segment_spmm(x, pa))  # noqa: E731
            else:
                bare = lambda: segment_spmm(x, a)  # noqa: E731
                sec = lambda: segment_spmm_secondary(x, a, l, degc, parts, 10.0)  # noqa: E731
            rec[name] = {"ok": torch.equal(bare().cpu().view(torch.int32), want.view(torch.int32)),
                         "b2b": time_cuda(bare), "dev": device_ms(bare),
                         "secondary_b2b": time_cuda(sec), "secondary_dev": device_ms(sec)}
        x = cases["twitter"][2]
        call = (lambda: pops.segment_spmm(x, hub_p)) if parent else (lambda: segment_spmm(x, hub))  # noqa: E731
        rec["hub"] = {"ok": torch.equal(call().cpu().view(torch.int32), hub_want.view(torch.int32)),
                      "b2b": time_cuda(call), "dev": device_ms(call)}
        results.setdefault(vname, []).append(rec)
        print(vname, json.dumps(rec), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print("VARIANTS " + json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
