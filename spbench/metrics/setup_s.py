"""Seconds from the harness's first line to the start of the first timed
unit: imports, the card's start, the kernel library's build or load, the
graph, the program's set-up and the warm-up units."""


def read(r):
    return r.setup_s
