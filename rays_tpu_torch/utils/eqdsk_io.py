"""G-EQDSK file read/write (``rays_tpu.utils.eqdsk_io``; host-side,
numpy, the port's own copy).

Format per reference RAYS_project/RAYS_lib/eqdsk_utilities_m.f90 (ReadgFile/
WritegFile, adapted there from R. Fitzpatrick's EPEC): 48-char header +
counts, 4x5 scalar records in 5e16.9, the 1-D profile arrays T (= R*Bphi),
P, TT', P', the psi(R, Z) grid in Fortran order, Q, then boundary/limiter
point lists.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GEqdsk:
    header: str
    nrbox: int
    nzbox: int
    rboxlen: float
    zboxlen: float
    r0: float
    rboxlft: float
    zoff: float
    raxis: float
    zaxis: float
    psiaxis: float
    psibound: float
    b0: float
    current: float
    T: np.ndarray        # R*Bphi on R grid (nrbox,)
    P: np.ndarray
    TTp: np.ndarray
    Pp: np.ndarray
    Q: np.ndarray
    psi: np.ndarray      # (nrbox, nzbox), psi[i, j] at (R_i, Z_j)
    rbound: np.ndarray
    zbound: np.ndarray
    rlim: np.ndarray
    zlim: np.ndarray

    @property
    def r_grid(self):
        return self.rboxlft + self.rboxlen * np.arange(self.nrbox) / (self.nrbox - 1)

    @property
    def z_grid(self):
        zmin = self.zoff - self.zboxlen / 2.0
        return zmin + self.zboxlen * np.arange(self.nzbox) / (self.nzbox - 1)


def _read_reals(tokens, n):
    vals = [float(tokens.pop(0)) for _ in range(n)]
    return np.asarray(vals)


def _tokenize_5e16(lines, start, count):
    """Read `count` floats laid out 5-per-line in e16.9 fields."""
    vals = []
    i = start
    while len(vals) < count:
        line = lines[i]
        for k in range(0, len(line.rstrip("\n")), 16):
            fld = line[k:k + 16].strip()
            if fld:
                vals.append(float(fld.replace("D", "E").replace("d", "e")))
            if len(vals) == count:
                break
        i += 1
    return np.asarray(vals[:count]), i


def read_geqdsk(path) -> GEqdsk:
    with open(path) as f:
        lines = f.readlines()
    header = lines[0][:48]
    tail = lines[0][48:].split()
    nrbox, nzbox = int(tail[-2]), int(tail[-1])

    scalars, i = _tokenize_5e16(lines, 1, 20)
    (rboxlen, zboxlen, r0, rboxlft, zoff,
     raxis, zaxis, psiaxis, psibound, b0,
     current) = scalars[:11]

    T, i = _tokenize_5e16(lines, i, nrbox)
    P, i = _tokenize_5e16(lines, i, nrbox)
    TTp, i = _tokenize_5e16(lines, i, nrbox)
    Pp, i = _tokenize_5e16(lines, i, nrbox)
    psi_flat, i = _tokenize_5e16(lines, i, nrbox * nzbox)
    # Fortran write order ((Psi(i,j), i=1,NRBOX), j=1,NZBOX)
    psi = psi_flat.reshape(nzbox, nrbox).T.copy()
    Q, i = _tokenize_5e16(lines, i, nrbox)

    nb_line = lines[i].split()
    nbound, nlim = int(nb_line[0]), int(nb_line[1])
    i += 1
    bpts, i = _tokenize_5e16(lines, i, 2 * nbound)
    rbound, zbound = bpts[0::2], bpts[1::2]
    lpts, i = _tokenize_5e16(lines, i, 2 * nlim)
    rlim, zlim = lpts[0::2], lpts[1::2]

    return GEqdsk(
        header=header, nrbox=nrbox, nzbox=nzbox,
        rboxlen=rboxlen, zboxlen=zboxlen, r0=r0, rboxlft=rboxlft, zoff=zoff,
        raxis=raxis, zaxis=zaxis, psiaxis=psiaxis, psibound=psibound, b0=b0,
        current=current, T=T, P=P, TTp=TTp, Pp=Pp, Q=Q, psi=psi,
        rbound=rbound, zbound=zbound, rlim=rlim, zlim=zlim,
    )


def _write_5e16(f, vals):
    vals = np.asarray(vals).ravel()
    for k in range(0, len(vals), 5):
        f.write("".join(f"{v:16.9e}" for v in vals[k:k + 5]) + "\n")


def write_geqdsk(path, eq: GEqdsk):
    """Write in the same layout ReadgFile consumes
    (eqdsk_utilities_m.f90:111-141)."""
    with open(path, "w") as f:
        f.write(f"{eq.header:<48s}{0:4d}{eq.nrbox:4d}{eq.nzbox:4d}\n")
        _write_5e16(f, [eq.rboxlen, eq.zboxlen, eq.r0, eq.rboxlft, eq.zoff])
        _write_5e16(f, [eq.raxis, eq.zaxis, eq.psiaxis, eq.psibound, eq.b0])
        _write_5e16(f, [eq.current, 0.0, 0.0, 0.0, 0.0])
        _write_5e16(f, [0.0] * 5)
        _write_5e16(f, eq.T)
        _write_5e16(f, eq.P)
        _write_5e16(f, eq.TTp)
        _write_5e16(f, eq.Pp)
        _write_5e16(f, eq.psi.T)  # ((psi(i,j), i), j) order
        _write_5e16(f, eq.Q)
        f.write(f"{len(eq.rbound):5d}{len(eq.rlim):5d}\n")
        bpts = np.empty(2 * len(eq.rbound))
        bpts[0::2], bpts[1::2] = eq.rbound, eq.zbound
        _write_5e16(f, bpts)
        lpts = np.empty(2 * len(eq.rlim))
        lpts[0::2], lpts[1::2] = eq.rlim, eq.zlim
        _write_5e16(f, lpts)
