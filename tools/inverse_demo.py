"""Adjoint inverse-problem demo with rays_tpu_torch, the counterpart of
scripts/inverse_demo.py: fit Solovev equilibrium parameters from ray
trajectory data.

Gradients of the ray trajectories with respect to equilibrium parameters
flow through the whole integration, so equilibrium reconstruction becomes
a fit.  A fan of rays is traced in a "true" Solovev equilibrium, (kappa,
iota0) are perturbed (+15%, -15%) and recovered from the trajectory
misfit: Adam (torch.optim, with the JAX script's cosine schedule), then
damped Gauss-Newton on (kappa, iota0), the two columns of the trajectory
Jacobian taken by forward mode (torch.autograd.forward_ad, as the JAX
script takes them by jax.jvp).  The JAX package's own run of this demo
ends FAIL (artifacts/inverse_demo.txt: the fit does not converge), so
nothing here promises convergence; it is held only at its starting point
(the loss, its gradient and the two Jacobian columns there).  The
trajectories go through ``trace_rays``: on the card the loss takes the
graph route, the gradient the graphed adjoint and the forward-mode
columns the tangent graph (``trace.route``), each captured at its first
call and replayed after.

    python tools/inverse_demo.py                  # on the card
    python tools/inverse_demo.py --device cpu --iters 5 --newton 1 --steps 20

Writes the log to --out (default build/inverse_demo.txt).  Exits 1 when
the fit does not recover both parameters to 1e-3, as the JAX script does.
"""

import argparse
import dataclasses
import os
import re
import sys
import time

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from rays_tpu_torch import examples  # noqa: E402
from rays_tpu_torch.tracing.trace import route, trace_rays  # noqa: E402

# The JAX script's experiment design (scripts/inverse_demo.py:29-60): the
# fan samples a full poloidal circuit of launch points with a spread of
# poloidal wavenumber, so that the refraction depends on the poloidal
# field that iota0 sets; the misfit is the whole trajectory, not the
# endpoints, which leave iota0 nearly unidentifiable.
_DEMO_INIT = """
&solovev_ray_init_nphi_ktheta_list
 n_r_launch=1, r_launch0=0.3, dr_launch=0.0,
 n_theta_launch=8, theta_launch0=0.0, dtheta_launch=0.7854,
 n_rindex_theta=2, rindex_theta0=0.15, delta_rindex_theta=0.3,
 n_rindex_phi=1, rindex_phi0=0.3, delta_rindex_phi=0.0
/
"""
START = (1.15, 0.85)   # the start: kappa and iota0 times these


def demo_text():
    return re.sub(r"&solovev_ray_init_nphi_ktheta_list.*?/\n", _DEMO_INIT.lstrip(),
                  examples.SOLOVEV_ECH_90GHZ, flags=re.S)


class InverseProblem:
    """The fan, its target trajectories in the true equilibrium, and the
    misfit as a function of theta = (kappa, iota0).  Fixed-step RK4 with
    trajectories on: the adaptive stepper differentiates only in its
    fixed-budget form, and RK4 is the cheaper adjoint."""

    def __init__(self, nstep_max=80, device="cuda"):
        cfg, self.params, self.v0, self.st, self.pwr = examples.setup_example(
            demo_text(), device=device)
        self.cfg = dataclasses.replace(cfg, nstep_max=nstep_max, save_trajectory=True,
                                       ode_solver_name="RK4_ODE")
        eq = self.params.eq
        self.true_theta = torch.stack([eq.kappa, eq.iota0])
        self.start = self.true_theta * torch.tensor(START, dtype=eq.kappa.dtype,
                                                    device=eq.kappa.device)
        with torch.no_grad():
            self.target = self.trajectories(self.true_theta)

    def trajectories(self, theta):
        p = self.params._replace(eq=self.params.eq._replace(kappa=theta[0], iota0=theta[1]))
        return trace_rays(self.cfg, p, self.v0, self.st, self.pwr).ray_vec[:, :, 0:3]

    def residual(self, theta):
        return (self.trajectories(theta) - self.target).reshape(-1)

    def value_and_grad(self, theta):
        """(loss, d loss / d theta) by reverse mode."""
        theta = theta.detach().requires_grad_(True)
        loss = (self.residual(theta) ** 2).sum()
        grad, = torch.autograd.grad(loss, theta)
        return loss.detach(), grad

    def jvp_column(self, theta, i):
        """(residual, J e_i): column i of the trajectory Jacobian by forward
        mode, one pass."""
        tangent = torch.zeros_like(theta)
        tangent[i] = 1.0
        with fwAD.dual_level():
            return tuple(fwAD.unpack_dual(self.residual(fwAD.make_dual(theta.detach(), tangent))))

    def jvp_columns(self, theta):
        """(residual, J e0, J e1): the two columns of the trajectory
        Jacobian by forward mode, one pass each."""
        r, j0 = self.jvp_column(theta, 0)
        return r, j0, self.jvp_column(theta, 1)[1]

    def gn_system(self, theta):
        """(loss, J^T J, J^T r) of the Gauss-Newton step."""
        r, j0, j1 = self.jvp_columns(theta)
        jtj = torch.stack([torch.stack([j0 @ j0, j0 @ j1]), torch.stack([j0 @ j1, j1 @ j1])])
        return (r ** 2).sum(), jtj, torch.stack([j0 @ r, j1 @ r])

    def loss(self, theta):
        with torch.no_grad():
            return (self.residual(theta) ** 2).sum()


def _timed(fn, device):
    """(seconds on the host's clock, fn()), the device synchronized
    around the call."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return time.perf_counter() - t0, out


def start_point(nstep_max=80, device="cuda"):
    """What the demo is held to: theta, the loss, its gradient and the two
    Jacobian columns at the starting point; the routes that the loss, the
    gradient and the columns take (``trace.route``); and the seconds of
    each part in this order (the loss alone, then the loss with its
    gradient, then each column), the first call of a route with its
    capture."""
    prob = InverseProblem(nstep_max, device)
    dev = prob.v0.device
    seconds = {}
    seconds["loss"], _ = _timed(lambda: prob.loss(prob.start), dev)
    seconds["gradient"], (loss, grad) = _timed(lambda: prob.value_and_grad(prob.start), dev)
    seconds["column 0"], (r, j0) = _timed(lambda: prob.jvp_column(prob.start, 0), dev)
    seconds["column 1"], (_, j1) = _timed(lambda: prob.jvp_column(prob.start, 1), dev)
    return {"theta": prob.start, "loss": loss, "grad": grad, "residual": r,
            "j0": j0, "j1": j1, "target": prob.target, "seconds": seconds,
            "routes": {"loss": route(prob.cfg, False, dev),
                       "gradient": route(prob.cfg, True, dev),
                       "columns": route(prob.cfg, False, dev, tangents=True)}}


def _solve2(a, b):
    """2x2 Cramer solve."""
    det = a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]
    return torch.stack([a[1, 1] * b[0] - a[0, 1] * b[1], a[0, 0] * b[1] - a[1, 0] * b[0]]) / det


def run_demo(n_iters=60, nstep_max=80, lr=3e-2, n_newton=8, log=print, device="cuda"):
    """Adam, then Levenberg-Marquardt-damped Gauss-Newton.  Returns the
    loss and parameter history, the true, start and final parameters,
    their relative errors and the wall time."""
    t0 = time.time()
    prob = InverseProblem(nstep_max, device)
    log(f"[{time.time() - t0:.1f}s] target trajectories traced on {prob.v0.device}")
    true_kappa, true_iota0 = prob.true_theta.tolist()
    theta = prob.start.clone()
    # cosine decay: Adam's per-coordinate normalization makes the weakly
    # identified iota0 axis oscillate at a constant rate near the optimum
    opt = torch.optim.Adam([theta], lr=lr)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=n_iters)
    log(f"true:  kappa={true_kappa:.6f} iota0={true_iota0:.6f}")
    log(f"start: kappa={float(theta[0]):.6f} iota0={float(theta[1]):.6f}")

    history = []
    for it in range(n_iters):
        loss, g = prob.value_and_grad(theta)
        history.append((float(loss), float(theta[0]), float(theta[1])))
        opt.zero_grad()
        theta.grad = g
        opt.step()
        sched.step()
        if it % 10 == 0 or it == n_iters - 1:
            log(f"  iter {it:3d}: loss={float(loss):.3e} "
                f"kappa={float(theta[0]):.6f} iota0={float(theta[1]):.6f}")

    # damped Gauss-Newton: adaptive damping shrinks steps toward gradient
    # descent far from the optimum and grows them toward Gauss-Newton on
    # the final descent of the kappa-iota0 ridge
    eye = torch.eye(2, dtype=theta.dtype, device=theta.device)
    mu_rel = 1e-4
    for it in range(n_newton):
        loss, jtj, jtr = prob.gn_system(theta)
        tr = float(torch.trace(jtj))
        accepted = False
        for _ in range(8):
            cand = theta - _solve2(jtj + (mu_rel * tr) * eye, jtr)
            loss_c = float(prob.loss(cand))
            if np.isfinite(loss_c) and loss_c < float(loss):
                accepted = True
                break
            mu_rel *= 10.0
        if not accepted:
            log(f"  gauss-newton {it}: no acceptable step (converged)")
            break
        mu_rel = max(mu_rel * 0.1, 1e-10)
        theta = cand
        history.append((loss_c, float(theta[0]), float(theta[1])))
        log(f"  gauss-newton {it}: loss={loss_c:.3e} "
            f"kappa={float(theta[0]):.6f} iota0={float(theta[1]):.6f}")

    k_err = abs(float(theta[0]) - true_kappa) / true_kappa
    i_err = abs(float(theta[1]) - true_iota0) / true_iota0
    log(f"[{time.time() - t0:.1f}s] recovered kappa rel-err={k_err:.2e}, "
        f"iota0 rel-err={i_err:.2e}")
    return {"history": history, "true": (true_kappa, true_iota0),
            "start": tuple(prob.start.tolist()), "final": tuple(theta.tolist()),
            "k_err": k_err, "i_err": i_err, "wall_s": time.time() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu for the CPU)")
    ap.add_argument("--iters", type=int, default=50, help="Adam iterations")
    ap.add_argument("--newton", type=int, default=8, help="Gauss-Newton iterations")
    ap.add_argument("--steps", type=int, default=80, help="RK4 steps of each trace")
    ap.add_argument("--out", default=os.path.join("build", "inverse_demo.txt"),
                    help="log file (default build/inverse_demo.txt)")
    args = ap.parse_args(argv)
    torch.zeros((), device=args.device)   # a device that is not there fails first
    lines = []

    def log(msg):
        print(msg, flush=True)
        lines.append(str(msg))

    out = run_demo(n_iters=args.iters, nstep_max=args.steps, lr=1e-2,
                   n_newton=args.newton, log=log, device=args.device)
    ok = out["k_err"] < 1e-3 and out["i_err"] < 1e-3
    log("PASS" if ok else "FAIL (fit did not converge: "
        f"k_err={out['k_err']:.2e} i_err={out['i_err']:.2e})")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
