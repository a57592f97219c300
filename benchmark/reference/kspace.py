"""The plain reference of the k-space pseudospectral solver, in PyTorch.

One heterogeneous, absorbing (power law), linear fluid medium inside a PML, as k-Wave's
`kspaceFirstOrder3D` and k-Wave-Fluid-CUDA's `KSpaceFirstOrderSolver` march it (Treeby
and Cox, "k-Wave: MATLAB toolbox for the simulation and reconstruction of photoacoustic
wave fields", J. Biomed. Opt. 15(2), 2010; Treeby et al., "Modeling nonlinear ultrasound
propagation in heterogeneous media with power law absorption using a k-space
pseudospectral method", JASA 131(6), 2012):

  u   = pml_sg * (pml_sg * u - dt / rho0_sg * ifft(i k e^{+i k d/2} kappa fft(p)))
  rho = pml * (pml * rho - dt * rho0 * ifft(i k e^{-i k d/2} kappa fft(u)))  (per axis)
  p   = c0^2 (sum rho + tau ifft(|k|^(y-2) fft(rho0 sum du)) - eta ifft(|k|^(y-1) fft(sum rho)))

with kappa = sinc(c_ref dt |k| / 2), tau and eta of the power law, and an initial pressure p0 that sets the state after the first step
(p = p0, rho = p0 / (3 c0^2), u = dt / (2 rho0_sg) ifft(i k e^{+i k d/2} kappa fft(p0))).
Fields are [nz, ny, nx], x fastest; sensors are flat indices into that order. Every
operator is built here from the inputs the benchmark made: nothing comes from the program.

``precision="float64"`` is the reference. ``precision="bfloat16"`` is its control: the
same arithmetic with every operator and every field rounded to bfloat16 as it is made
(torch has no bfloat16 FFT, so the transforms run in float32 on bfloat16 values), the step
that a lower-precision program would take.
"""

from __future__ import annotations

import math
import torch


class _Precision:
    def __init__(self, precision: str):
        if precision not in ("float64", "bfloat16"):
            raise ValueError(f"precision {precision!r}: float64 or bfloat16")
        self.real = torch.float64 if precision == "float64" else torch.float32
        self.lossy = precision == "bfloat16"

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """A real or complex tensor as this precision stores it."""
        if not self.lossy:
            return x
        if x.is_complex():
            return torch.complex(self(x.real), self(x.imag))
        return x.to(torch.bfloat16).to(torch.float32)


def _signed_k(n: int, d: float, dtype) -> torch.Tensor:
    return 2.0 * math.pi * torch.fft.fftfreq(n, d, dtype=dtype)


def _pml(n: int, size: int, alpha_max: float, c_ref: float, d: float, dt: float,
         staggered: bool, dtype) -> torch.Tensor:
    """k-Wave's PML profile along one axis: exp(-alpha_max (x/L)^4 c_ref dt / (2 d))
    inside the layer of ``size`` cells at both ends, 1 elsewhere."""
    x = torch.arange(n, dtype=torch.float64) + (0.5 if staggered else 0.0)
    ramp = torch.maximum((size - x).clamp(min=0), (x - (n - 1 - size)).clamp(min=0))
    ramp = ramp / max(size, 1)
    pml = torch.exp(-alpha_max * ramp ** 4 * c_ref * dt / (2.0 * d))
    return torch.where(ramp == 0, torch.ones_like(pml), pml).to(dtype)


def _stagger(rho: torch.Tensor, axis: int) -> torch.Tensor:
    """rho at the half-cell forward point: the mean of a cell and the next, the last
    cell's own value at the far edge."""
    fwd = torch.roll(rho, -1, dims=axis)
    last = [slice(None)] * rho.ndim
    last[axis] = slice(-1, None)
    fwd[tuple(last)] = rho[tuple(last)]
    return 0.5 * (rho + fwd)


class Reference:
    """The medium's operators on ``device`` and the step.

    ``inputs``: shape (nz, ny, nx), dx, dt, c0 and rho0 (float32 tensors), alpha_coeff,
    alpha_power, pml_size and pml_alpha (x, y, z), and the initial pressure p0 (a field).
    """

    def __init__(self, inputs: dict, device, precision: str = "float64"):
        q = self.q = _Precision(precision)
        real = q.real
        self.inputs = inputs
        nz, ny, nx = self.shape = tuple(inputs["shape"])
        d, dt = float(inputs["dx"]), float(inputs["dt"])
        self.dt = dt
        c0 = inputs["c0"].to(device, torch.float64)
        rho0 = inputs["rho0"].to(device, torch.float64)
        c_ref = float(c0.max())

        kx = _signed_k(nx, d, torch.float64)[: nx // 2 + 1].abs().to(device)
        ky = _signed_k(ny, d, torch.float64).to(device)
        kz = _signed_k(nz, d, torch.float64).to(device)
        kmag = torch.sqrt(kz[:, None, None] ** 2 + ky[None, :, None] ** 2
                          + kx[None, None, :] ** 2)
        arg = c_ref * dt / 2.0 * kmag
        self.kappa = q(torch.where(arg == 0, torch.ones_like(arg),
                                   torch.sin(arg) / torch.where(arg == 0, 1.0, arg)).to(real))
        y = float(inputs["alpha_power"])
        safe = torch.where(kmag == 0, torch.ones_like(kmag), kmag)
        self.nabla1 = q(torch.where(kmag == 0, 0.0, safe ** (y - 2.0)).to(real))
        self.nabla2 = q(torch.where(kmag == 0, 0.0, safe ** (y - 1.0)).to(real))
        del kmag, arg, safe

        cplx = torch.complex128 if real == torch.float64 else torch.complex64

        def dd(k, n, nyquist, sign):  # i k e^{+-i k d/2}, real at the Nyquist bin
            op = 1j * k * torch.exp(sign * 1j * k * d / 2.0)
            if n % 2 == 0:
                op[nyquist] = op[nyquist].real.clone()
            return q(op.to(cplx))

        self.dd_pos = (dd(kx, nx, -1, 1), dd(ky, ny, ny // 2, 1)[:, None],
                       dd(kz, nz, nz // 2, 1)[:, None, None])
        self.dd_neg = (dd(kx, nx, -1, -1), dd(ky, ny, ny // 2, -1)[:, None],
                       dd(kz, nz, nz // 2, -1)[:, None, None])

        size, alpha = inputs["pml_size"], inputs["pml_alpha"]
        self.pml = []
        self.pml_sg = []
        for axis, n in enumerate((nx, ny, nz)):
            view = [(1, 1, -1), (1, -1, 1), (-1, 1, 1)][axis]
            for out, sg in ((self.pml, False), (self.pml_sg, True)):
                out.append(q(_pml(n, int(size[axis]), float(alpha[axis]), c_ref, d, dt, sg,
                                  real).to(device).reshape(view)))
        self.rho0 = q(rho0.to(real))
        self.dt_rho0_sg = [q((dt / _stagger(rho0, a)).to(real)) for a in (2, 1, 0)]
        self.c2 = q((c0 * c0).to(real))
        alpha_np = (100.0 * (1.0e-6 / (2.0 * math.pi)) ** y) / (20.0 * math.log10(math.e))
        a2 = 2.0 * float(inputs["alpha_coeff"]) * alpha_np
        self.tau = q((-a2 * c0 ** (y - 1.0)).to(real))
        self.eta = q((a2 * c0 ** y * math.tan(math.pi / 2.0 * y)).to(real))
        del c0, rho0

    # -- spectral helpers ------------------------------------------------------------
    def _fft(self, x):
        return torch.fft.rfftn(x, dim=(0, 1, 2))

    def _ifft(self, xk):
        return self.q(torch.fft.irfftn(xk, s=self.shape, dim=(0, 1, 2)))

    def _grad(self, field, ops):
        fk = self._fft(field) * self.kappa
        return [self._ifft(fk * op) for op in ops]

    # -- the state -------------------------------------------------------------------
    def initial_state(self, p0: torch.Tensor) -> dict:
        """The state after the first step of a run with an initial pressure p0."""
        q = self.q
        p0 = q(p0.to(self.kappa.device, self.q.real))
        rho = q(p0 / (3.0 * self.c2))
        g = self._grad(p0, self.dd_pos)
        u = [q(0.5 * s * gi) for s, gi in zip(self.dt_rho0_sg, g)]
        return {"p": p0, "ux": u[0], "uy": u[1], "uz": u[2],
                "rx": rho, "ry": rho.clone(), "rz": rho.clone()}

    def step(self, s: dict) -> dict:
        q = self.q
        dpx, dpy, dpz = self._grad(s["p"], self.dd_pos)
        u = [q(pml * (pml * s[k] - r * g)) for pml, k, r, g in
             zip(self.pml_sg, ("ux", "uy", "uz"), self.dt_rho0_sg, (dpx, dpy, dpz))]
        du = [self._ifft(self._fft(ui) * self.kappa * op) for ui, op in zip(u, self.dd_neg)]
        rho = [q(pml * (pml * s[k] - self.dt * self.rho0 * d)) for pml, k, d in
               zip(self.pml, ("rx", "ry", "rz"), du)]
        rho_sum = q(rho[0] + rho[1] + rho[2])
        du_sum = q(du[0] + du[1] + du[2])
        tau_term = self._ifft(self._fft(q(self.rho0 * du_sum)) * self.nabla1)
        eta_term = self._ifft(self._fft(rho_sum) * self.nabla2)
        p = q(self.c2 * (rho_sum + self.tau * tau_term - self.eta * eta_term))
        return {"p": p, "ux": u[0], "uy": u[1], "uz": u[2],
                "rx": rho[0], "ry": rho[1], "rz": rho[2]}


def simulate(inputs: dict, nt: int, sensors: torch.Tensor, device,
             precision: str = "float64") -> torch.Tensor:
    """``nt`` steps from p0: the pressure at ``sensors``, row t the state after step t, as
    float64 [nt, N] on the host."""
    ref = Reference(inputs, device, precision)
    idx = sensors.to(device)
    state = ref.initial_state(inputs["p0"])
    rows = [state["p"].reshape(-1)[idx]]
    for _ in range(1, nt):
        state = ref.step(state)
        rows.append(state["p"].reshape(-1)[idx])
    return torch.stack(rows).to("cpu", torch.float64)
