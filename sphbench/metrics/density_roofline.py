"""The density's share of its roofline, in %: the least time of the
traced window's density calls (`counts.py`, pairs within h from the
reference's trajectory) over the device time of the kernels that
`stages/` assigns to the density."""

from sphbench.rooflines import share


def read(run):
    return share(run, "density")
