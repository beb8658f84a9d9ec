"""Seconds from the start of the process to the start of the window:
imports, the kernels' build (first run in a checkout) or load, the inputs
made from the seed, the program built, the warm prefix of the traffic."""


def read(r):
    return r.setup_s
