"""The force's share of its roofline, in %: as the density's, for the
kernels that `stages/` assigns to the force."""

from sphbench.rooflines import share


def read(run):
    return share(run, "force")
