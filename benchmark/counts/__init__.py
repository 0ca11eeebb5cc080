"""Operation and byte counts of the measured models and kernels, from the
configuration's shapes: one file per model or kernel. Operations are the
multiply-adds of convolutions and matrix products, times two (what an
MFU counts); elementwise work is left out."""
