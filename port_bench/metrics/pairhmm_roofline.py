"""K1 and K2 (ops/pairhmm_cuda.py, csrc/pairhmm.cu): the window's summed
bound time of its pair-HMM calls over the device time of the kernels
named pairhmm, %."""

from pbench.readers import roofline_pct


def read(w):
    return roofline_pct(w, "pairhmm", "pairhmm")
