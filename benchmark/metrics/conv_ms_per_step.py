"""Device ms of cuDNN's convolutions (their NCHW <-> NHWC layout kernels
included: trace.KINDS' `convolution`) per sampler step of the traced
jobs; the encoder's convolutions ride along, once a job."""


def read(run):
    steps = sum(r.out["steps"] for r in run.traced())
    sec = run.summary["by_kind"].get("convolution")
    return 1e3 * sec / steps if steps and sec else None
