"""The device trace of a traced run: torch.profiler over the traced phase,
reduced to kernel time by kind, the device's busy time, and the idle gaps
named by what the host was doing.

KINDS is a frozen copy of the kernel-name grouping of the measured
package's profile_decode.py (its `KINDS`).
"""
from __future__ import annotations

import time

KINDS = [("k2_turbo_gn_apply", ("gn_turbo_kernel",)),
         ("k3_k4a_flash_attention_forward", ("flash_fwd", "flash_serve")),
         ("k4b_flash_attention_dkv", ("flash_dkv",)),
         ("k4c_flash_attention_dq", ("flash_dq",)),
         ("k5_grouped_gn", ("ggn_apply_kernel", "ggn_cluster_kernel")),
         ("k1_groupnorm_apply", ("gn_apply_kernel",)),
         ("gn_stats_k1_k5", ("gn_stats_kernel",)),
         ("convolution", ("conv", "cudnn", "implicit", "fprop", "winograd")),
         ("int8_matmul", ("gemm_s8", "i16832", "imma", "s8s8")),
         ("matmul", ("gemm", "cutlass", "gemv", "xmma", "nvjet")),
         ("optimizer", ("multi_tensor", "foreach", "adam")),
         ("elementwise_and_glue", ("elementwise", "vectorized", "reduce", "cat",
                                   "copy", "fill", "index", "softmax"))]

def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


class Tracer:
    """torch.profiler's device activity (CUPTI: kernels and copies) started
    and stopped around the traced phase. Host operators are not recorded:
    at ~2 us an operator that would double the host's time in the
    launch-paced cells; the host side comes from the harness's own spans
    (systems/common.HostSpans), on the same wall clock."""

    def __init__(self):
        self.prof = None
        self.events = None
        self.t_ns = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t_ns = [time.time_ns(), None]

    def stop(self) -> float:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t = time.perf_counter()
        self.t_ns[1] = time.time_ns()
        self.prof.stop()
        self.events = _kineto_events(self.prof)
        self.prof = None
        return t


def _ns(e, what):
    f = getattr(e, f"{what}_ns", None)
    return f() if f is not None else getattr(e, f"{what}_us")() * 1000


def _kineto_events(prof):
    """[(name, is_device, start_ns, end_ns, is_annotation)] of the trace."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = str(e.device_type()).endswith("CUDA")
        start = _ns(e, "start")
        dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
        ann = bool(e.is_user_annotation()) if hasattr(e, "is_user_annotation") else False
        out.append((e.name(), dev, start, start + dur, ann))
    return out


def summarize(events, host_spans=(), top: int = 10) -> dict:
    """Kernel seconds by name and kind, busy seconds (the union of kernel
    and copy intervals), and idle seconds by what the host was doing: each
    gap between kernels is charged to the innermost harness span open at
    its start and to the kind of the kernel that ended it (`span/kind`)."""
    kernels = [(n, s, e) for n, dev, s, e, ann in events
               if dev and not ann and e > s and not n.startswith(("Memcpy", "Memset"))]
    copies = [(n, s, e) for n, dev, s, e, ann in events
              if dev and not ann and n.startswith(("Memcpy", "Memset"))]
    by_name: dict[str, list] = {}
    for n, s, e in kernels:
        row = by_name.setdefault(n, [0.0, 0])
        row[0] += (e - s) * 1e-9
        row[1] += 1
    by_kind: dict[str, float] = {}
    for n, (sec, _) in by_name.items():
        k = kind_of(n)
        by_kind[k] = by_kind.get(k, 0.0) + sec
    ivals = sorted((s, e, n) for n, s, e in kernels + copies)
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e, n in ivals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += (cur_e - cur_s) * 1e-9
                gaps.append((cur_e, s, n))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += (cur_e - cur_s) * 1e-9
    spans = sorted((s, e, n) for n, s, e in host_spans)
    idle: dict[str, float] = {}
    for g0, g1, nxt in gaps:
        name, start = "none", -1
        for s, e, n in spans:
            if s > g0:
                break
            if e >= g0 and s > start:
                name, start = n, s
        key = f"{name}/{kind_of(nxt) if not nxt.startswith('Mem') else nxt.split()[0]}"
        idle[key] = idle.get(key, 0.0) + (g1 - g0) * 1e-9
    return {"by_name": by_name, "by_kind": by_kind, "busy_s": busy,
            "first_ns": ivals[0][0] if ivals else None,
            "idle_by_host": idle,
            "breakdown": {
                "device_ops": sorted(([k, v] for k, v in by_kind.items()),
                                     key=lambda r: -r[1])[:top],
                "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                    key=lambda r: -r[1])[:top]}}
