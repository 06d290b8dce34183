"""Small versions of the cells for the CPU tests: the same fan over the
same ranges, with fewer rays and steps."""


def shrink(cell, counts, steps):
    """Cut ``cell``'s traffic to ``counts`` points on its scan axes, in
    order, and ``steps`` outer steps."""
    scan = [dict(axis, n=n) for axis, n in zip(cell.traffic["scan"], counts)]
    rays = 1
    for n in counts:
        rays *= n
    cell.traffic = dict(cell.traffic, scan=scan, rays=rays, nstep_max=steps)
