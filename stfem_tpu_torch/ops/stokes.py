"""Matrix-free Stokes saddle-point operator on structured meshes
(counterpart of stfem_tpu/ops/stokes.py::StokesOperator; the DGP or the
continuous FE_Q pressure, with strong, Nitsche or free velocity faces, on
uniform, masked, non-uniform and exactly mapped meshes, linear or in the
Navier modes).

Weak form per cell (reference include/operators.h:1525-1575):
  u-row:  nu (grad u, grad v) - (p, div v) [- convection]
  p-row:  (div u, q)
Velocity: vector Q_k (component axis leading), pressure: modal DGP (or
nodal FE_Q, below).  The operator acts batched over arbitrary leading
axes (time positions).

Flat packing: a Stokes space-time vector is [T, n_u + n_p] with
u = x[:, :n_u].reshape(T, dim, *dofgrid) and
p = x[:, n_u:].reshape(T, *cells, n_ploc).

The quadrature is stfem_tpu's (the same 1D shape data and Gauss rule);
the per-axis sum factorization becomes one matmul against the full-cell
basis gradients (A x dim*Q, 27 x 81 for Q2 with 3 points per axis), which
computes the same sums in fewer, larger launches.  On a uniform mesh the
inverse steps and the weights are folded into the two tables; otherwise
the tables are the reference gradients and the geometry is applied per
cell: the inverse steps of a non-uniform grid, or the inverse Jacobian
per (cell, quadrature point) of a mapped one.

The Navier modes (reference OperatorMode dispatch, operators.h:1530-1567)
add the convection of the linearization velocity u_lin to the gradient
term, every component pair at once: "jacobian" subtracts u_lin_c du_d +
du_c u_lin_d, "form" (the Picard / Oseen operator) u_c u_lin_d.  Only in
those modes the CIP interior-face gradient-jump penalty (delta0) and the
backflow term on the free faces (outflow_penalty) enter.

Weak faces (reference do_boundary_face_integral_local and
StokesNitscheMatrixFreeOperator, operators.h:1658-1951): each listed
boundary face (axis, side) carries Nitsche terms with penalties gamma1 =
nu penalty1 and gamma2 = penalty2 over the face size, and its velocity
dofs stay free.  A face's terms are one batched pass over its layer of
cells, every velocity component at once; the per-face tables are built
once, at construction.  Free (do-nothing) faces are unconstrained and
carry no term.  A removed cell's velocity dofs are eliminated (the
strong obstacle of the DFG channel), or, with weak_obstacle, only those
that no active cell carries: the obstacle's faces then carry the same
Nitsche terms with g = 0, as dense per-face matrices over the (possibly
curved) face quadrature, built once.  Every sum over faces or planes
that meet a dof is owner-computes (utils/assembly.py::layer_sources):
no float atomics.

dg_pressure=False selects the Taylor-Hood pair Q_{k+1}/Q_k with a
continuous nodal pressure (reference tp_03stokes.cc:83-86; stfem_tpu's
dg_pressure switch): p = x[:, n_u:].reshape(T, *pdofgrid), the pressure
eliminated on the nodes of removed cells (mask_p), its values at the
quadrature points a cell gather and the full-cell nodal basis, the
continuity (div u, q) rows an overlap-add back onto the nodes, and the
Nitsche pressure terms the nodal trace on the boundary plane.  The weak
obstacle takes the DGP pair only.
"""
from __future__ import annotations

import numpy as np
import torch

from ..mesh.fe import q_nodes_1d, shape_data_1d
from ..mesh.fe_dgp import (dgp_exponents, dgp_values_at_tensor_gauss,
                           n_dgp_dofs, shifted_legendre_value)
from ..mesh.grid import StructuredMesh, map_jacobians, map_points
from ..time.quadrature import LagrangeBasis, gauss
from ..utils.assembly import (cell_dof_indices, layer_sources,
                              overlap_sources)
from .spatial import (LaplaceMassOperator, _sumfac, basis_tensors,
                      cell_gather, cell_scatter, geometry_factors, layer_sum)

__all__ = ["StokesOperator", "obstacle_faces", "face_basis",
           "face_jacobians"]


def obstacle_faces(mesh):
    """All interior faces between active and removed cells: a list of
    (axis d, index of the ACTIVE cell, side), side 1 where the obstacle
    lies on the + side of the active cell."""
    cm = mesh.cell_mask
    assert cm is not None
    out = []
    dim = mesh.dim
    for d in range(dim):
        lo, hi = [slice(None)] * dim, [slice(None)] * dim
        lo[d], hi[d] = slice(0, -1), slice(1, None)
        diff = cm[tuple(lo)] - cm[tuple(hi)]
        for idx in np.argwhere(diff == 1.0):      # active | removed
            out.append((d, tuple(int(i) for i in idx), 1))
        for idx in np.argwhere(diff == -1.0):     # removed | active
            jdx = [int(i) for i in idx]
            jdx[d] += 1
            out.append((d, tuple(jdx), 0))
    return out


def face_basis(dim: int, k: int, nq: int, p_degree: int, d0: int,
               side: int):
    """Reference-cell tables at the Gauss points of the cell face (d0,
    side), the face points lexicographic over the other axes: the Q_k
    basis values Phi[a, q], its reference gradients G[e, a, q] and the
    modal DGP(p_degree) pressure trace P[m, q] (NumPy float64)."""
    edge = np.array([float(side)])
    basis = LagrangeBasis(np.asarray(q_nodes_1d(k)))
    V1e, D1e = basis.eval_matrix(edge)[0], basis.deriv_matrix(edge)[0]
    sd = shape_data_1d(k, nq)
    qx = gauss(nq)[0]
    oth = [d for d in range(dim) if d != d0]
    A, Qf = (k + 1) ** dim, nq ** (dim - 1)
    a_idx = np.stack(np.meshgrid(*[np.arange(k + 1)] * dim, indexing="ij"),
                     -1).reshape(A, dim)
    q_idx = np.stack(np.meshgrid(*[np.arange(nq)] * len(oth),
                                 indexing="ij"), -1).reshape(Qf, len(oth))
    Phi = np.ones((A, Qf))
    G = np.ones((dim, A, Qf))
    for d in range(dim):
        if d == d0:
            Phi *= V1e[a_idx[:, d]][:, None]
            for e in range(dim):
                G[e] *= (D1e if e == d0 else V1e)[a_idx[:, d]][:, None]
        else:
            j = oth.index(d)
            Phi *= sd.S[q_idx[None, :, j], a_idx[:, d, None]]
            for e in range(dim):
                G[e] *= (sd.D if e == d else sd.S)[q_idx[None, :, j],
                                                   a_idx[:, d, None]]
    exps = dgp_exponents(dim, p_degree)
    P = np.ones((len(exps), Qf))
    for m, ex in enumerate(exps):
        P[m] *= shifted_legendre_value(ex[d0], edge)[0]
        for j, d in enumerate(oth):
            P[m] *= shifted_legendre_value(ex[d], qx)[q_idx[:, j]]
    return Phi, G, P


def face_jacobians(mesh: StructuredMesh, cidx: np.ndarray, d0: int,
                   side: int, nq: int) -> np.ndarray:
    """[Fg, Qf, dim, dim] float64 Jacobians of the reference-cell map at
    the Gauss points of the faces (d0, side) of the cells cidx [Fg, dim]:
    the diagonal of the cell's steps, times the vertex map's Jacobian
    (through torch.func, in float64) on a mapped mesh."""
    dim = mesh.dim
    qx = gauss(nq)[0]
    Qf = nq ** (dim - 1)
    hs = np.stack([mesh.steps(d)[cidx[:, d]] for d in range(dim)], -1)
    if mesh.vertex_map is None:
        J = np.zeros((len(cidx), Qf, dim, dim))
        J[..., range(dim), range(dim)] = hs[:, None, :]
        return J
    oth = [d for d in range(dim) if d != d0]
    starts = [mesh.axis_vertices(d)[:-1] for d in range(dim)]
    pts = np.zeros((len(cidx), Qf, dim))
    pts[..., d0] = (starts[d0][cidx[:, d0]] + hs[:, d0] * side)[:, None]
    q_idx = np.stack(np.meshgrid(*[np.arange(nq)] * len(oth),
                                 indexing="ij"), -1).reshape(Qf, len(oth))
    for j, d in enumerate(oth):
        pts[..., d] = (starts[d][cidx[:, d], None]
                       + hs[:, d, None] * qx[q_idx[:, j]])
    Jm = map_jacobians(mesh.vertex_map, pts.reshape(-1, dim))
    return Jm.reshape(len(cidx), Qf, dim, dim) * hs[:, None, None, :]


def _overlap_1d(y: torch.Tensor, k: int) -> torch.Tensor:
    """[..., P, k+1] -> [..., P k + 1]: the overlap-add of P consecutive
    node rows that share their end nodes (cell_scatter along one axis)."""
    P = y.shape[-2]
    out = torch.nn.functional.pad(
        y[..., :k].reshape(y.shape[:-2] + (P * k,)), (0, 1))
    out[..., k::k] += y[..., k]
    return out


class StokesOperator:
    def __init__(self, mesh: StructuredMesh, u_degree: int, p_degree: int,
                 n_q: int, viscosity: float = 1.0, dtype=torch.float64,
                 device="cuda", dg_pressure: bool = True, weak_faces=(),
                 free_faces=(), penalty1: float = 20.0,
                 penalty2: float = 10.0, delta0: float = 0.0,
                 outflow_penalty: float = 0.0, weak_obstacle: bool = False):
        """weak_faces: boundary faces (axis, side) with Nitsche weak
        Dirichlet conditions; they are not eliminated from the velocity
        mask (corners shared with a strong face stay eliminated).
        free_faces: do-nothing faces (the DFG outflow), unconstrained and
        without a term in the linear modes.  delta0: the CIP penalty and
        outflow_penalty the backflow penalty of the Navier modes.  On a
        masked mesh every dof of a removed cell is eliminated (the strong
        obstacle), or, with weak_obstacle, only those that no active cell
        carries, and the obstacle's faces carry Nitsche no-slip terms."""
        if weak_obstacle and not dg_pressure and mesh.cell_mask is not None:
            # stfem_tpu ops/stokes.py:640 asserts the same
            raise ValueError("the weak obstacle is implemented for the DGP "
                             "pressure pair")
        self.mesh = mesh
        self.dim = dim = mesh.dim
        self.u_degree = u_degree
        self.p_degree = p_degree
        self.n_q = n_q
        self.viscosity = float(viscosity)
        self.delta0 = float(delta0)
        self.beta = float(outflow_penalty)
        self.dtype = dtype
        self.device = torch.device(device)
        self.dg_pressure = bool(dg_pressure)
        self.cells = mesh.cells
        self.dof_shape_u = mesh.dof_shape(u_degree)
        self.n_ploc = n_dgp_dofs(dim, p_degree)
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                         device=self.device)
        if not self.dg_pressure:
            # the nodal Q_{p_degree} pressure grid, eliminated on the nodes
            # of removed cells (stfem_tpu ops/stokes.py:67-81)
            self.dof_shape_p = mesh.dof_shape(p_degree)
            self._Sp = as_t(shape_data_1d(p_degree, n_q).S)    # (q, kp+1)
            maskp = np.ones(self.dof_shape_p)
            if mesh.cell_mask is not None:
                maskp = np.zeros(self.dof_shape_p)
                for cidx in np.argwhere(mesh.cell_mask == 1.0):
                    maskp[tuple(slice(int(c) * p_degree,
                                      int(c) * p_degree + p_degree + 1)
                                for c in cidx)] = 1.0
            self.mask_p_np = maskp
            self.mask_p = as_t(maskp)
        self.weak_faces = tuple((int(d), int(s)) for d, s in weak_faces)
        self.free_faces = tuple((int(d), int(s)) for d, s in free_faces)
        if mesh.vertex_map is not None and (self.weak_faces
                                            or self.free_faces):
            self._check_identity_on_boundary()
        self.gamma1 = self.viscosity * float(penalty1)
        self.gamma2 = float(penalty2)
        # strong faces eliminated, weak and free faces unconstrained, the
        # removed cells' dofs eliminated again, or with a weak obstacle
        # only the dofs that no active cell carries (stfem_tpu
        # ops/stokes.py:132-182)
        self.weak_obstacle = bool(weak_obstacle) and mesh.cell_mask is not None
        unconstrained = self.weak_faces + self.free_faces
        mask = mesh.boundary_dof_mask(u_degree)
        for d0, side in unconstrained:
            mask[self._plane(d0, side)] = 1.0
        cell_dofs = lambda cidx: tuple(
            slice(int(c) * u_degree, int(c) * u_degree + u_degree + 1)
            for c in cidx)
        if self.weak_obstacle:
            mask = np.zeros(self.dof_shape_u)
            for cidx in np.argwhere(mesh.cell_mask == 1.0):
                mask[cell_dofs(cidx)] = 1.0
        elif mesh.cell_mask is not None:
            for cidx in np.argwhere(mesh.cell_mask == 0.0):
                mask[cell_dofs(cidx)] = 0.0
        for d in range(dim):
            for side in (0, 1):
                if (d, side) not in unconstrained:
                    mask[self._plane(d, side)] = 0.0
        self.mask_u_np = mask
        self.mask_u = as_t(mask)
        # modal pressure basis at the tensor Gauss points (reference cell)
        self.Pq = as_t(dgp_values_at_tensor_gauss(dim, p_degree, n_q))
        self._Pb = (self.Pq.reshape(self.n_ploc, -1) if self.dg_pressure
                    else as_t(basis_tensors(dim, p_degree, n_q)[0]))
        self.n_u = dim * int(np.prod(self.dof_shape_u))
        self.n_p = (int(np.prod(self.cells)) * self.n_ploc if self.dg_pressure
                    else int(np.prod(self.dof_shape_p)))
        self.uniform = mesh.uniform
        phi, self._grad_ref = basis_tensors(dim, u_degree, n_q)
        self._Phi = as_t(phi)                                 # [A, Q]
        self._set_geometry(mesh.geometry(n_q))
        self._eye = torch.eye(dim, dtype=dtype, device=self.device).reshape(
            dim, 1, dim, 1)
        self._S1 = as_t(shape_data_1d(u_degree, n_q).S)      # (q, k+1)
        self._faces = [self._face_setup(d0, side)
                       for d0, side in self.weak_faces]
        self._free = [self._face_setup(d0, side)
                      for d0, side in self.free_faces]
        basis = LagrangeBasis(np.asarray(q_nodes_1d(u_degree)))
        # CIP traces at a cell's ends: d/dx at 1 and 0, the value at 1
        self._cip = [as_t(basis.deriv_matrix(np.array([1.0]))[0]),
                     as_t(basis.deriv_matrix(np.array([0.0]))[0]),
                     as_t(basis.eval_matrix(np.array([1.0]))[0])]
        self._obstacle = (self._obstacle_face_setup() if self.weak_obstacle
                          else None)

    def _set_geometry(self, geom):
        """The geometry tables of the apply from a Geometry: on a uniform
        mesh the full-cell basis gradients, physical (x jinv): G[a, e*Q +
        q], and with the integration weights folded in for the transposed
        apply; otherwise the reference gradients and their transpose, and
        per cell the inverse steps [C, dim, 1] (and x weights [C, dim,
        Q]) or jinv[c, q, e, d] as [C, e, d, Q] (and x weights)."""
        dim, C = self.dim, int(np.prod(self.cells))
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=self.dtype,
                                         device=self.device)
        self.geom = geom
        self.jxw = as_t(geom.jxw)
        self.jinv_diag = (None if geom.jinv_diag is None
                          else np.asarray(geom.jinv_diag, np.float64))
        self.jfac, self.jinv = geometry_factors(geom, self.cells, self.dtype,
                                                self.device)
        grad = self._grad_ref
        A, Q = grad.shape[1], grad.shape[2]
        if self.uniform:
            gphys = grad * self.jinv_diag[:, None, None]
            self._G = as_t(np.transpose(gphys, (1, 0, 2)).reshape(A,
                                                                  dim * Q))
            w = np.asarray(geom.jxw, np.float64).reshape(1, 1, Q)
            gw = np.transpose(gphys * w, (0, 2, 1))         # [dim, Q, A]
            self._GW = as_t(gw.reshape(dim * Q, A))
            self._wq = self.jxw.reshape(-1)
            return
        self._G = as_t(np.transpose(grad, (1, 0, 2)).reshape(A, dim * Q))
        self._GW = self._G.T.contiguous()
        self._wq = torch.broadcast_to(
            self.jxw, self.cells + (self.n_q,) * dim).reshape(C, Q)
        if self.jinv is None:
            self._jf = torch.stack([torch.broadcast_to(
                self.jfac[e], self.cells + (1,) * dim).reshape(C)
                for e in range(dim)], dim=1)[:, :, None]
            self._jfw = self._jf * self._wq[:, None, :]
        else:
            ji = self.jinv.reshape(C, Q, dim, dim).permute(0, 2, 3, 1)
            self._ji = ji.contiguous()
            self._jiw = (ji * self._wq[:, None, None, :]).contiguous()

    def _check_identity_on_boundary(self):
        """Faces use the axis-aligned tensor-face tables: on a mapped mesh
        the map must be the identity, with an identity Jacobian, on the
        outer boundary (the DFG morph has compact support around the
        obstacle; stfem_tpu ops/stokes.py:96-116)."""
        mesh, dim = self.mesh, self.dim
        axes = [mesh.axis_vertices(d) for d in range(dim)]
        base = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
        for d in range(dim):
            for side in (0, 1):
                pts = base[self._plane(d, side, dim)].reshape(-1, dim)
                ok_v = np.allclose(map_points(mesh.vertex_map, pts), pts,
                                   atol=1e-12)
                ok_j = np.allclose(map_jacobians(mesh.vertex_map, pts),
                                   np.eye(dim), atol=1e-10)
                if not (ok_v and ok_j):
                    raise ValueError("faces on a mapped mesh need the map "
                                     "to be the identity (with its "
                                     "Jacobian) on the outer boundary")

    def _plane(self, d0: int, side: int, ndim: int | None = None):
        """Index of the boundary dof plane (axis d0, side) of a grid."""
        idx = [slice(None)] * (self.dim if ndim is None else ndim)
        idx[d0] = 0 if side == 0 else -1
        return tuple(idx)

    # -- packing ------------------------------------------------------------
    def pack(self, u: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        lead = u.shape[:-self.dim - 1]
        return torch.cat([u.reshape(lead + (self.n_u,)),
                          p.reshape(lead + (self.n_p,))], dim=-1)

    def unpack(self, x: torch.Tensor):
        lead = x.shape[:-1]
        u = x[..., :self.n_u].reshape(lead + (self.dim,) + self.dof_shape_u)
        p = x[..., self.n_u:].reshape(lead + self.p_shape)
        return u, p

    @property
    def p_shape(self) -> tuple[int, ...]:
        """Per-block pressure shape: [*cells, n_ploc] (DGP modal) or
        [*pdofgrid] (FE_Q nodal)."""
        return (self.cells + (self.n_ploc,) if self.dg_pressure
                else self.dof_shape_p)

    @property
    def n_ploc_cell(self) -> int:
        """Local pressure dofs per cell: DGP modes or Q_{kp} nodal values."""
        return (self.n_ploc if self.dg_pressure
                else (self.p_degree + 1) ** self.dim)

    def _p_basis_at_quad(self) -> torch.Tensor:
        """[n_ploc_cell, Q] local pressure basis at the tensor Gauss points
        (modal shifted Legendre for DGP, nodal Lagrange for FE_Q)."""
        return self._Pb

    def _p_local(self, p: torch.Tensor) -> torch.Tensor:
        """[..., *p_shape] -> the cell-local pressure dofs [..., C,
        n_ploc_cell] (FE_Q: masked nodal values, gathered per cell)."""
        lead = p.shape[:p.ndim - len(self.p_shape)]
        C = int(np.prod(self.cells))
        if not self.dg_pressure:
            p = cell_gather(p * self.mask_p, self.cells, self.p_degree)
        return p.reshape(lead + (C, self.n_ploc_cell))

    def _p_to_grid(self, y: torch.Tensor) -> torch.Tensor:
        """Transpose of _p_local: [..., C, n_ploc_cell] -> [..., *p_shape]
        (FE_Q: overlap-added onto the nodes, then masked)."""
        lead = y.shape[:-2]
        if self.dg_pressure:
            return y.reshape(lead + self.p_shape)
        kp = self.p_degree
        y = y.reshape(lead + self.cells + (kp + 1,) * self.dim)
        return cell_scatter(y, self.cells, kp) * self.mask_p

    def _p_at_quad(self, p: torch.Tensor) -> torch.Tensor:
        """[..., *p_shape] -> [..., C, Q]."""
        return self._p_local(p) @ self._Pb

    # -- gradients at the quadrature points ----------------------------------
    def _grad_phys(self, uc: torch.Tensor) -> torch.Tensor:
        """Cell-local values [..., C, A] -> physical gradients at the quad
        points [..., C, dim, Q]."""
        g = (uc @ self._G).reshape(uc.shape[:-1] + (self.dim, -1))
        if self.uniform:
            return g
        if self.jinv is None:
            return g * self._jf
        # d_d u = sum_e d_e u (reference) jinv[e, d]
        return (g.unsqueeze(-2) * self._ji).sum(-3)

    def _int_grad_phys(self, t: torch.Tensor) -> torch.Tensor:
        """[..., C, dim, Q] -> sum_d (d_d v, t[d]) against the cell-local
        test functions [..., C, A] (includes the jxw measure)."""
        if not self.uniform:
            t = (t * self._jfw if self.jinv is None
                 else (t.unsqueeze(-3) * self._jiw).sum(-2))
        return t.reshape(t.shape[:-2] + (-1,)) @ self._GW

    # -- apply --------------------------------------------------------------
    def apply(self, u: torch.Tensor, p: torch.Tensor, mode: str = "none",
              u_lin: torch.Tensor | None = None, mask_input: bool = True):
        """(ru, rp); u: [..., dim, *dofgrid], p: [..., *p_shape].
        mode "none" is linear Stokes; "jacobian" (the Navier
        linearization: the gradient term less u_lin (x) du + du (x)
        u_lin) and "form" (the Oseen operator: less du (x) u_lin) take the
        linearization velocity u_lin [..., dim, *dofgrid] (reference
        OperatorMode dispatch, operators.h:1530-1567).  mask_input=False
        reads the eliminated velocity dofs too (the strong Dirichlet
        lift), the output stays masked."""
        if mode not in ("none", "jacobian", "form"):
            raise ValueError(f"operator mode {mode!r}")
        navier = mode != "none"
        dim, k = self.dim, self.u_degree
        C = int(np.prod(self.cells))
        lead = u.shape[:-dim - 1]
        if mask_input:
            u = u * self.mask_u
        uc = cell_gather(u, self.cells, k).reshape(lead + (dim, C, -1))
        g = self._grad_phys(uc)                    # [..., c, C, d, Q]
        div = torch.diagonal(g, dim1=-4, dim2=-2).sum(-1)   # [..., C, Q]
        p_q = self._p_at_quad(p)                   # [..., C, Q]
        rp = self._p_to_grid((div * self._wq) @ self._Pb.T)
        t = self.viscosity * g - self._eye * p_q.unsqueeze(-2).unsqueeze(-4)
        if navier:
            # values at the quad points, [..., c, C, Q]; as_d puts the
            # component on the d axis of t: [..., 1, C, d, Q]
            v = uc @ self._Phi
            vl = cell_gather(u_lin * self.mask_u, self.cells, k).reshape(
                u_lin.shape[:-dim - 1] + (dim, C, -1)) @ self._Phi
            as_d = lambda w: w.transpose(-3, -2).unsqueeze(-4)
            if mode == "jacobian":
                t = t - (vl.unsqueeze(-2) * as_d(v)
                         + v.unsqueeze(-2) * as_d(vl))
            else:
                t = t - v.unsqueeze(-2) * as_d(vl)
        ru = self._int_grad_phys(t)                # [..., c, C, A]
        ru = cell_scatter(ru.reshape(lead + (dim,) + self.cells
                                     + (k + 1,) * dim), self.cells, k)
        if self.weak_faces:
            ru_n, rp_n = self.apply_nitsche(u, p)
            ru, rp = ru + ru_n, rp + rp_n
        if self._obstacle is not None:
            ru_o, rp_o = self.apply_nitsche_obstacle(u, p)
            ru, rp = ru + ru_o, rp + rp_o
        if navier and self.delta0 != 0.0:
            ru = ru + self.apply_cip(u, u_lin, self.delta0)
        if navier and self.beta != 0.0 and self.free_faces:
            ru = ru + self.apply_backflow(u, u_lin, self.beta)
        return ru * self.mask_u, rp

    def apply_flat(self, x: torch.Tensor) -> torch.Tensor:
        u, p = self.unpack(x)
        ru, rp = self.apply(u, p)
        return self.pack(ru, rp)

    # -- cell-local layout ----------------------------------------------------
    def local_maps(self):
        """(lidx (C, W), src (n, 2, .., 2)) int64 NumPy, W = dim A +
        n_ploc_cell: lidx[c, w] is the flat index into one block's
        [n_u + n_p] vector of cell c's local entry w (velocity
        component-major, then the pressure modes or nodes); src lists each
        flat entry's positions in a flat (C, W) cell-local array as
        utils/assembly.py::overlap_sources does (a DGP mode has one, a
        nodal pressure dof one per cell that holds it), C W where there is
        none, so that their sum over the trailing axes, last first, is the
        overlap-add in cell_scatter's order."""
        dim, k = self.dim, self.u_degree
        C = int(np.prod(self.cells))
        A = (k + 1) ** dim
        n_pl = self.n_ploc_cell
        W = dim * A + n_pl
        n_s = int(np.prod(self.dof_shape_u))

        def shared(kk, base):
            """Local indices and sources of a Q_kk grid whose cell-local
            entries start at column base of each cell's W."""
            src = overlap_sources(self.cells, kk)
            cell, a = np.divmod(src, (kk + 1) ** dim)
            return (cell_dof_indices(self.cells, kk),
                    np.where(src == C * (kk + 1) ** dim, C * W,
                             cell * W + base + a))

        g, src_s = shared(k, 0)
        lidx_u = [g + c * n_s for c in range(dim)]
        src_u = [np.where(src_s == C * W, C * W, src_s + c * A)
                 for c in range(dim)]
        if self.dg_pressure:
            lidx_p = (self.n_u + np.arange(C)[:, None] * n_pl
                      + np.arange(n_pl)[None, :])
            src_p = np.full((C * n_pl,) + (2,) * dim, C * W, np.int64)
            src_p[(slice(None),) + (1,) * dim] = (
                np.arange(C)[:, None] * W + dim * A
                + np.arange(n_pl)[None, :]).reshape(-1)
        else:
            gp, src_p = shared(self.p_degree, dim * A)
            lidx_p = self.n_u + gp
        return (np.concatenate(lidx_u + [lidx_p], axis=1),
                np.concatenate(src_u + [src_p]))

    # -- element matrices for the Vanka patches -----------------------------
    def element_matrices(self, masked: bool = True):
        """(E_uu_scalar, E_up, E_pu): E_uu_scalar = nu-scaled scalar Laplace
        element matrices [C, A, A] (identical per component); E_up [C,
        dim*A, n_ploc_cell] (u rows component-major): -int d_c phi_a psi_m;
        E_pu [C, n_ploc_cell, dim*A]: +int psi_m d_c phi_a, psi_m the
        modal DGP or the cell-local nodal FE_Q basis (for FE_Q the
        assembled coupling is the neighbour-overlap sum, which the Vanka
        build does).  The eliminated velocity rows/cols and FE_Q pressure
        columns are zeroed unless masked is False.  The Nitsche face terms
        are face_element_matrices'."""
        dim, k = self.dim, self.u_degree
        lap = LaplaceMassOperator(self.mesh, k, self.n_q, 0.0,
                                  self.viscosity, dtype=self.dtype,
                                  device=self.device, mask=self.mask_u_np)
        lap._set_geometry(self.geom)
        E_uu = lap.element_matrices(masked)
        Grad = self._grad_ref
        C = int(np.prod(self.cells))
        A = (k + 1) ** dim
        Q = self.n_q ** dim
        wq = torch.broadcast_to(self.jxw, self.cells + (self.n_q,) * dim
                                ).reshape(C, Q)
        Pq = self._p_basis_at_quad()
        Grad = torch.as_tensor(Grad, dtype=self.dtype, device=self.device)
        parts = []
        if self.jinv is not None:
            gphys = torch.einsum("cqed,eaq->cdaq",
                                 self.jinv.reshape(C, Q, dim, dim), Grad)
        for c in range(dim):
            if self.jinv is not None:
                parts.append(-torch.einsum("cq,caq,mq->cam", wq, gphys[:, c],
                                           Pq))
                continue
            jf = (float(self.jinv_diag[c]) if self.jinv_diag is not None
                  else self._jf[:, c])
            parts.append(-torch.einsum("cq,aq,mq->cam", wq * jf, Grad[c],
                                       Pq))
        E_up = torch.cat(parts, dim=1)
        if masked:
            mloc = cell_gather(self.mask_u, self.cells, k).reshape(C, A)
            E_up = E_up * torch.cat([mloc] * dim, dim=1)[:, :, None]
            if not self.dg_pressure:
                # the eliminated (removed-cell) pressure nodes
                E_up = E_up * cell_gather(self.mask_p, self.cells,
                                          self.p_degree).reshape(C, 1, -1)
        E_pu = -E_up.transpose(1, 2)
        return E_uu, E_up, E_pu

    # -- Nitsche weak boundary faces -----------------------------------------
    def _face_setup(self, d0: int, side: int) -> dict:
        """Per-face tables (stfem_tpu ops/stokes.py::_face_setup): the
        normal-derivative weights of the edge node row (k+1,), the face
        quadrature weights [*cells_oth, *q_oth], the face size hf
        [*cells_oth, 1..], the normal cell size h0, the modal pressure
        trace [n_ploc, Qf] and the physical face quadrature points
        [*cells_oth, *q_oth, dim]."""
        dim, k, mesh, nq = self.dim, self.u_degree, self.mesh, self.n_q
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=self.dtype,
                                         device=self.device)
        edge_x = 0.0 if side == 0 else 1.0
        n_sign = -1.0 if side == 0 else 1.0
        oth = [d for d in range(dim) if d != d0]
        cells_oth = tuple(self.cells[d] for d in oth)
        m = dim - 1
        qx, qw = gauss(nq)
        D1e = LagrangeBasis(np.asarray(q_nodes_1d(k))).deriv_matrix(
            np.array([edge_x]))[0]
        jxw = np.ones(cells_oth + (nq,) * m)
        hf = np.ones(cells_oth)
        for i, d in enumerate(oth):
            cshape, qshape, hshape = [1] * (2 * m), [1] * (2 * m), [1] * m
            cshape[i], qshape[m + i], hshape[i] = self.cells[d], nq, \
                self.cells[d]
            steps = mesh.steps(d)
            jxw = jxw * steps.reshape(cshape) * qw.reshape(qshape)
            hf = hf * steps.reshape(hshape)
        hf = (hf ** (1.0 / max(m, 1))).reshape(cells_oth + (1,) * m)
        h0 = float(mesh.steps(d0)[0 if side == 0 else -1])
        exps = dgp_exponents(dim, self.p_degree)
        Pqf = np.ones((len(exps),) + (nq,) * m)
        for j, e in enumerate(exps):
            Pqf[j] *= shifted_legendre_value(e[d0], np.array([edge_x]))[0]
            for i, d in enumerate(oth):
                shape = [1] * m
                shape[i] = nq
                Pqf[j] = Pqf[j] * shifted_legendre_value(
                    e[d], qx).reshape(shape)
        coords = np.zeros(cells_oth + (nq,) * m + (dim,))
        coords[..., d0] = mesh.lower[d0] if side == 0 else mesh.upper[d0]
        for i, d in enumerate(oth):
            v = mesh.axis_vertices(d)
            pos = v[:-1, None] + np.diff(v)[:, None] * qx[None, :]
            shape = [1] * (2 * m)
            shape[i], shape[m + i] = self.cells[d], nq
            coords[..., d] = pos.reshape(shape)
        return dict(d0=d0, side=side, n_sign=n_sign, oth=oth,
                    cells_oth=cells_oth, h0=h0, D1edge_np=D1e,
                    mask_p=(None if self.dg_pressure
                            else self.mask_p[self._plane(d0, side)]),
                    # d/dn of the layer's k+1 node rows at the face
                    prof=as_t(D1e * (n_sign / h0)),
                    jxw=as_t(jxw), jxw_np=jxw, hf=as_t(hf), hf_np=hf,
                    Pqf=as_t(Pqf.reshape(len(exps), -1)),
                    Pqf_np=Pqf.reshape(len(exps), -1),
                    coords=torch.as_tensor(coords, dtype=torch.float64,
                                           device=self.device))

    def _trace_eval(self, field, cells_oth, pressure: bool = False):
        """[..., *dofs_oth] -> [..., *cells_oth, *q_oth] (of the velocity
        grid, or with pressure of the FE_Q pressure grid)."""
        m = self.dim - 1
        k, S1 = ((self.p_degree, self._Sp) if pressure
                 else (self.u_degree, self._S1))
        return _sumfac([S1] * m, cell_gather(field, cells_oth, k), m)

    def _trace_integrate(self, vals, cells_oth, pressure: bool = False):
        """Transpose of _trace_eval: [..., *cells_oth, *q_oth] ->
        [..., *dofs_oth]."""
        m = self.dim - 1
        k, S1 = ((self.p_degree, self._Sp) if pressure
                 else (self.u_degree, self._S1))
        return cell_scatter(_sumfac([S1] * m, vals, m, forward=False),
                            cells_oth, k)

    def _p_face_terms(self, p_b, un_w, f):
        """The pressure side of a Nitsche face: (pq, rp_add) -- the
        pressure trace [..., *cells_oth, *q_oth] (None when p_b is None)
        and the (q n, u) row [..., *plane] from un_w = (u . n) jxw on the
        face points.  p_b is the pressure's boundary plane: the DGP modes
        of the layer cells [..., *cells_oth, n_ploc], or the FE_Q nodes
        [..., *pdofs_oth] (masked here; stfem_tpu ops/stokes.py:537-546)."""
        cells_oth = f["cells_oth"]
        if self.dg_pressure:
            lead = un_w.shape[:un_w.ndim - 2 * (self.dim - 1)] + cells_oth
            pq = None if p_b is None else (p_b @ f["Pqf"]).reshape(
                un_w.shape)
            return pq, -(un_w.reshape(lead + (-1,)) @ f["Pqf"].T)
        mp = f["mask_p"]
        pq = None if p_b is None else self._trace_eval(p_b * mp, cells_oth,
                                                       True)
        return pq, -self._trace_integrate(un_w, cells_oth, True) * mp

    def _layer(self, f: dict):
        """(start, length) of the boundary cell layer's k+1 node rows
        along the face normal."""
        k = self.u_degree
        n = self.dof_shape_u[f["d0"]]
        return (0, k + 1) if f["side"] == 0 else (n - k - 1, k + 1)

    def apply_nitsche(self, u: torch.Tensor, p: torch.Tensor):
        """Weak-face contributions (ru_add, rp_add), u: [..., dim, *grid]
        (masked by apply() unless its mask_input is False), p: [...,
        *p_shape].  Per face, every component at once: the traces
        of u and of its normal derivative at the face quadrature points,
        the penalty, consistency and pressure terms, and the adjoint
        consistency term on the normal derivative of the test functions."""
        dim = self.dim
        nu = self.viscosity
        L = u.ndim - dim - 1
        ru, rp = torch.zeros_like(u), torch.zeros_like(p)
        for f in self._faces:
            d0, n_sign, cells_oth = f["d0"], f["n_sign"], f["cells_oth"]
            ax = L + 1 + d0                      # the normal axis of u
            eidx = 0 if f["side"] == 0 else -1
            start, length = self._layer(f)
            jxw, hf = f["jxw"], f["hf"]
            uq = self._trace_eval(u.select(ax, eidx), cells_oth)
            dn = torch.movedim(u.narrow(ax, start, length), ax, -1) @ f["prof"]
            dnq = self._trace_eval(dn, cells_oth)   # [..., dim, cells, q]
            un = n_sign * uq.select(L, d0)
            pq, rp_add = self._p_face_terms(p.select(L + d0, eidx),
                                            un * jxw, f)
            rp.select(L + d0, eidx).add_(rp_add)
            t1 = (self.gamma1 / hf) * uq - nu * dnq
            t1.select(L, d0).add_((self.gamma2 / hf) * n_sign * un
                                  + n_sign * pq)
            ru.select(ax, eidx).add_(self._trace_integrate(t1 * jxw,
                                                           cells_oth))
            y2 = self._trace_integrate((-nu * uq) * jxw, cells_oth)
            shape = [1] * (y2.ndim + 1)
            shape[ax] = length
            ru.narrow(ax, start, length).add_(
                y2.unsqueeze(ax) * f["prof"].reshape(shape))
        return ru, rp

    def nitsche_rhs(self, g_fn, t):
        """Right-hand side of the weak Dirichlet data g(x, t) (reference
        StokesNitscheMatrixFreeOperator::vmult): (rhs_u [dim, *grid],
        rhs_p [*p_shape]).  g_fn(points [..., dim] float64 tensor,
        t) returns [..., dim]."""
        dim = self.dim
        nu = self.viscosity
        rhs_u = torch.zeros((dim,) + tuple(self.dof_shape_u),
                            dtype=self.dtype, device=self.device)
        rhs_p = torch.zeros(self.p_shape, dtype=self.dtype,
                            device=self.device)
        for f in self._faces:
            d0, n_sign, cells_oth = f["d0"], f["n_sign"], f["cells_oth"]
            eidx = 0 if f["side"] == 0 else -1
            start, length = self._layer(f)
            jxw, hf = f["jxw"], f["hf"]
            g = torch.movedim(g_fn(f["coords"], t).to(self.dtype), -1, 0)
            gn = n_sign * g[d0]                  # [*cells_oth, *q_oth]
            rhs_p.select(d0, eidx).add_(self._p_face_terms(None, gn * jxw,
                                                           f)[1])
            t1 = (self.gamma1 / hf) * g
            t1[d0] += (self.gamma2 / hf) * n_sign * gn
            rhs_u.select(1 + d0, eidx).add_(
                self._trace_integrate(t1 * jxw, cells_oth))
            y2 = self._trace_integrate((-nu * g) * jxw, cells_oth)
            shape = [1] * (y2.ndim + 1)
            shape[1 + d0] = length
            rhs_u.narrow(1 + d0, start, length).add_(
                y2.unsqueeze(1 + d0) * f["prof"].reshape(shape))
        # contributions landing on eliminated dofs (corners shared with
        # strong faces) must not enter the residual
        return rhs_u * self.mask_u, rhs_p

    def face_element_matrices(self):
        """Per weak face: (d0, side, Fuu, Fup, Fpu), the Nitsche terms of
        the boundary-layer cells' element matrices (reference
        compute_matrix_helper incl. faces, operators.h:1472-1494).  Fuu:
        one (C_layer, A, A) per component; Fup (C_layer, dim*A,
        n_ploc_cell) with component-major rows (the modal or the nodal
        pressure trace); Fpu its transpose with the p-row sign.
        Built in float64 NumPy, returned in the operator's dtype."""
        dim, k, nq = self.dim, self.u_degree, self.n_q
        nu = self.viscosity
        A = (k + 1) ** dim
        m = dim - 1
        Qf = nq ** m
        S1 = shape_data_1d(k, nq).S
        locs = np.stack(np.meshgrid(*([np.arange(k + 1)] * dim),
                                    indexing="ij"), -1).reshape(A, dim)
        q_idx = np.stack(np.meshgrid(*([np.arange(nq)] * m), indexing="ij"),
                         -1).reshape(Qf, m)
        as_t = lambda a: torch.as_tensor(a, dtype=self.dtype,
                                         device=self.device)
        out = []
        for f in self._faces:
            d0, side, oth, n_sign = f["d0"], f["side"], f["oth"], f["n_sign"]
            C_layer = int(np.prod(f["cells_oth"]))
            jxwf = f["jxw_np"].reshape(C_layer, Qf)
            hf = f["hf_np"].reshape(C_layer, 1)
            edge_loc = 0 if side == 0 else k
            # trace and normal derivative of every cell basis function at
            # the face quadrature points
            tr = (locs[:, d0] == edge_loc).astype(float)[:, None] \
                * np.ones((1, Qf))
            Dn = (f["D1edge_np"][locs[:, d0]] * n_sign / f["h0"])[:, None] \
                * np.ones((1, Qf))
            for i, d in enumerate(oth):
                vals = S1[q_idx[:, i][None, :], locs[:, d][:, None]]
                tr, Dn = tr * vals, Dn * vals
            pen0 = np.einsum("cq,aq,bq->cab", jxwf, tr, tr)
            con = (np.einsum("cq,aq,bq->cab", jxwf, tr, Dn)
                   + np.einsum("cq,aq,bq->cab", jxwf, Dn, tr))
            Fuu = []
            for c in range(dim):
                g = self.gamma1 / hf + (self.gamma2 / hf if c == d0 else 0.0)
                Fuu.append(as_t(pen0 * g[:, :, None] - nu * con))
            n_pl = self.n_ploc_cell
            Pqf = f["Pqf_np"]
            if not self.dg_pressure:
                # the nodal FE_Q pressure trace of the cell-local basis
                # (stfem_tpu ops/stokes.py:835-849)
                kp = self.p_degree
                Sp1 = shape_data_1d(kp, nq).S
                locsp = np.stack(np.meshgrid(*([np.arange(kp + 1)] * dim),
                                             indexing="ij"), -1).reshape(
                                                 n_pl, dim)
                Pqf = (locsp[:, d0] == (0 if side == 0 else kp)).astype(
                    float)[:, None] * np.ones((1, Qf))
                for i, d in enumerate(oth):
                    Pqf = Pqf * Sp1[q_idx[:, i][None, :], locsp[:, d][:, None]]
            blk = np.einsum("cq,aq,mq->cam", jxwf, tr, Pqf) * n_sign
            Fup = np.zeros((C_layer, dim * A, n_pl))
            Fpu = np.zeros((C_layer, n_pl, dim * A))
            Fup[:, d0 * A:(d0 + 1) * A, :] = blk          # + p n . v
            Fpu[:, :, d0 * A:(d0 + 1) * A] = -np.transpose(blk, (0, 2, 1))
            out.append((d0, side, Fuu, as_t(Fup), as_t(Fpu)))
        return out

    # -- the Navier modes' stabilizations ------------------------------------
    def apply_cip(self, u: torch.Tensor, u_lin: torch.Tensor | None,
                  delta0: float) -> torch.Tensor:
        """CIP interior-face convective stabilization, the contribution to
        ru (stfem_tpu ops/stokes.py::apply_cip; reference
        do_face_integral_local, operators.h:1605-1633): on every interior
        plane of each axis the jump of the normal derivative, penalized by
        delta0 h_f^2 / (k^3 sqrt k) (b . n)^2 with b the linearization
        velocity's trace from the left cell (u when u_lin is None) and the
        other axes lumped on the nodes (stfem_tpu's quadrature).  Every
        component at once; each plane's left and right layer terms are
        overlap-added along the axis (no scatter-add)."""
        dim, k = self.dim, self.u_degree
        L = u.ndim - dim - 1
        D_at1, D_at0, V_at1 = self._cip
        pa = k ** 3 * np.sqrt(k)
        b = u if u_lin is None else u_lin
        ru = torch.zeros_like(u)
        for d0 in range(dim):
            if self.cells[d0] < 2:
                continue
            h0 = float(self.mesh.h[d0])
            w_oth = float(np.prod([self.mesh.h[d] for d in range(dim)
                                   if d != d0]))
            hf = w_oth ** (1.0 / max(dim - 1, 1))
            delta_K = delta0 * hf * hf / pa
            # the cells along the axis as node rows [.., nc, k+1]; plane j
            # lies between rows j and j+1
            rows = torch.movedim(u, L + 1 + d0, -1).unfold(-1, k + 1, k)
            jump = (rows[..., :-1, :] @ (D_at1 / h0)
                    - rows[..., 1:, :] @ (D_at0 / h0))   # [.., c, *o, P]
            brows = torch.movedim(b.select(L, d0), L + d0, -1).unfold(
                -1, k + 1, k)
            bn = brows[..., :-1, :] @ V_at1               # [.., *o, P]
            t = (delta_K * bn * bn).unsqueeze(-dim - 1) * jump * w_oth
            upd = torch.nn.functional.pad(
                _overlap_1d(t[..., None] * (D_at1 / h0), k), (0, k)) \
                + torch.nn.functional.pad(
                    _overlap_1d(t[..., None] * (-D_at0 / h0), k), (k, 0))
            ru = ru + torch.movedim(upd, -1, L + 1 + d0)
        return ru * self.mask_u

    def apply_backflow(self, u: torch.Tensor, u_lin: torch.Tensor | None,
                       beta: float) -> torch.Tensor:
        """Bertoglio-Caiazzo backflow value term on the do-nothing faces,
        the contribution to ru: ru_c += int_F -0.5 beta b_c (u . n) v_c
        with b the linearization velocity (u when u_lin is None)
        (stfem_tpu ops/stokes.py::apply_backflow; reference
        do_boundary_face_integral_local's outflow branch,
        operators.h:1680-1714, whose gradient part is multiplied by a
        literal 0)."""
        dim = self.dim
        L = u.ndim - dim - 1
        b = u if u_lin is None else u_lin
        Lb = b.ndim - dim - 1
        ru = torch.zeros_like(u)
        for f in self._free:
            d0, cells_oth = f["d0"], f["cells_oth"]
            eidx = 0 if f["side"] == 0 else -1
            un = f["n_sign"] * self._trace_eval(
                u.select(L + 1 + d0, eidx).select(L, d0), cells_oth)
            bq = self._trace_eval(b.select(Lb + 1 + d0, eidx), cells_oth)
            t = -0.5 * beta * bq * un.unsqueeze(-2 * dim + 1) * f["jxw"]
            ru.select(L + 1 + d0, eidx).add_(self._trace_integrate(
                t, cells_oth))
        return ru * self.mask_u

    # -- the weak (Nitsche) obstacle -----------------------------------------
    def _obstacle_face_setup(self) -> dict | None:
        """The Nitsche no-slip terms of the obstacle faces (stfem_tpu
        ops/stokes.py::_obstacle_face_setup; the reference's boundary-face
        integral, operators.h:1658-1751, on the curved cylinder too), as
        dense per-face local matrices over the face quadrature: Nanson
        normals n ds = detJ J^-T n_ref dxi, physical gradients through
        J^-1 (J from face_jacobians), the face size the physical area^(1/
        (dim-1)).  Built once in float64 NumPy, the faces of one (axis,
        side) batched.  Returns None without obstacle faces, else
        dict(E_uu [F, dim, dim, A, A], E_up [F, dim, A, n_ploc] in the
        operator's dtype, uidx [F, A] flat dof-grid indices and pidx [F]
        flat cell indices (NumPy), and the owner-computes tables of the
        sums over faces: u_dofs, u_table over the flat (F, A) entries and
        p_cells, p_table over the faces, utils/assembly.py::
        layer_sources')."""
        mesh, dim, k, nq = self.mesh, self.dim, self.u_degree, self.n_q
        nu = self.viscosity
        faces = obstacle_faces(mesh)
        if not faces:
            return None
        A, m, Qf = (k + 1) ** dim, self.n_ploc, nq ** (dim - 1)
        qw = gauss(nq)[1]
        wq = np.ones(1)
        for _ in range(dim - 1):
            wq = (wq[:, None] * qw[None, :]).reshape(-1)
        F = len(faces)
        E_uu = np.zeros((F, dim, dim, A, A))
        E_up = np.zeros((F, dim, A, m))
        cflat = np.zeros(F, np.int64)
        for d0 in range(dim):
            for side in (0, 1):
                sel = [i for i, (d, _, s) in enumerate(faces)
                       if d == d0 and s == side]
                if not sel:
                    continue
                cidx = np.asarray([faces[i][1] for i in sel])
                cflat[sel] = np.ravel_multi_index(cidx.T, mesh.cells)
                Phi, G, P = face_basis(dim, k, nq, self.p_degree, d0, side)
                J = face_jacobians(mesh, cidx, d0, side, nq)
                detJ = np.linalg.det(J)
                Jinv = np.linalg.inv(J)                # [f, q, ref, phys]
                n_sign = 1.0 if side == 1 else -1.0    # out of the fluid
                wn = n_sign * detJ[..., None] * Jinv[:, :, d0, :]
                nrm = np.linalg.norm(wn, axis=-1)
                ds_w = nrm * wq                        # [f, q]
                n_unit = wn / nrm[..., None]           # [f, q, dim]
                Gn = np.einsum("eaq,fqed,fqd->faq", G, Jinv, n_unit)
                hf = ds_w.sum(-1) ** (1.0 / max(dim - 1, 1))
                mass = np.einsum("aq,fq,bq->fab", Phi, ds_w, Phi)
                adj = np.einsum("aq,fbq,fq->fab", Phi, Gn, ds_w)
                blk = (self.gamma2 / hf)[:, None, None, None, None] * \
                    np.einsum("aq,fq,fqc,fqe,bq->fceab", Phi, ds_w, n_unit,
                              n_unit, Phi)
                blk[:, range(dim), range(dim)] += (
                    (self.gamma1 / hf)[:, None, None] * mass - nu * adj
                    - nu * adj.transpose(0, 2, 1))[:, None]
                E_uu[sel] = blk
                E_up[sel] = np.einsum("aq,fq,fqc,mq->fcam", Phi, ds_w,
                                      n_unit, P)
        uidx = cell_dof_indices(mesh.cells, k)[cflat]
        u_dofs, u_table = layer_sources(list(uidx))
        p_cells, p_table = layer_sources([[c] for c in cflat])
        dev = self.device
        as_i = lambda a: torch.as_tensor(a, device=dev)
        return dict(E_uu=torch.as_tensor(E_uu, dtype=self.dtype, device=dev),
                    E_up=torch.as_tensor(E_up, dtype=self.dtype, device=dev),
                    uidx=uidx, pidx=cflat, uidx_t=as_i(uidx),
                    pidx_t=as_i(cflat), u_dofs=as_i(u_dofs),
                    u_table=as_i(u_table), p_cells=as_i(p_cells),
                    p_table=as_i(p_table))

    def apply_nitsche_obstacle(self, u: torch.Tensor, p: torch.Tensor):
        """The weak no-slip obstacle's contributions (ru_add, rp_add), the
        weak form of apply_nitsche with g = 0 on the (curved) obstacle
        faces: gather each face's cell values, the local matvec, and an
        owner-computes sum over the faces that meet a dof or a cell."""
        ob = self._obstacle
        dim = self.dim
        L = u.ndim - dim - 1
        u_flat = u.reshape(u.shape[:L + 1] + (-1,))
        u_loc = u_flat[..., ob["uidx_t"]]                 # [..., dim, F, A]
        p_flat = p.reshape(p.shape[:L] + (-1, self.n_ploc))
        p_loc = p_flat[..., ob["pidx_t"], :]              # [..., F, m]
        ru_loc = (torch.einsum("fceab,...efb->...cfa", ob["E_uu"], u_loc)
                  + torch.einsum("fcam,...fm->...cfa", ob["E_up"], p_loc))
        rp_loc = -torch.einsum("fcam,...cfa->...fm", ob["E_up"], u_loc)
        ru = torch.zeros_like(u_flat)
        ru[..., ob["u_dofs"]] = torch.movedim(layer_sum(
            [torch.movedim(ru_loc.flatten(-2), -1, 0)], ob["u_table"]), 0, -1)
        rp = torch.zeros_like(p_flat)
        rp[..., ob["p_cells"], :] = torch.movedim(layer_sum(
            [torch.movedim(rp_loc, -2, 0)], ob["p_table"]), 0, -2)
        return ru.reshape(u.shape), rp.reshape(p.shape)

    def obstacle_cell_terms(self):
        """The obstacle's Nitsche terms summed per active cell (once, an
        owner-computes sum over its faces): (cells [n] int64 tensor,
        E_uu [n, dim, dim, A, A], E_up [n, dim, A, n_ploc]) for the
        element route and the Vanka patches; None without a weak
        obstacle."""
        ob = self._obstacle
        if ob is None:
            return None
        return (ob["p_cells"], layer_sum([ob["E_uu"]], ob["p_table"]),
                layer_sum([ob["E_up"]], ob["p_table"]))
