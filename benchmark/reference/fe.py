"""1D building blocks of the reference, written from the textbook
definitions: Gauss, Gauss-Lobatto and right Gauss-Radau points on [0, 1],
Lagrange bases on them, the Q_k mass and stiffness matrices of a uniform
1D mesh, and the dG(r) time tables of one step.  NumPy float64 only."""
from __future__ import annotations

import numpy as np
from numpy.polynomial import legendre as leg


def gauss(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre points and weights on [0, 1]."""
    x, w = leg.leggauss(n)
    return (x + 1.0) / 2.0, w / 2.0


def _legendre(n: int) -> np.ndarray:
    c = np.zeros(n + 1)
    c[n] = 1.0
    return c


def _polish(x: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Newton steps on the roots x of the Legendre series c."""
    dc = leg.legder(c)
    for _ in range(4):
        x = x - leg.legval(x, c) / leg.legval(x, dc)
    return x


def gauss_lobatto_points(n: int) -> np.ndarray:
    """The n Gauss-Lobatto points on [0, 1]: the ends and the roots of
    P'_{n-1}."""
    if n < 2:
        raise ValueError("Gauss-Lobatto needs two points or more")
    dc = leg.legder(_legendre(n - 1))
    inner = _polish(np.sort(leg.legroots(dc).real), dc)
    return (np.concatenate(([-1.0], inner, [1.0])) + 1.0) / 2.0


def radau_right_points(n: int) -> np.ndarray:
    """The n right Gauss-Radau points on [0, 1] (the last one is 1): the
    roots of P_{n-1} - P_n."""
    if n == 1:
        return np.array([1.0])
    c = np.zeros(n + 1)
    c[n - 1], c[n] = 1.0, -1.0
    x = np.sort(leg.legroots(c).real)
    x[:-1] = _polish(x[:-1], c)
    x[-1] = 1.0
    return (x + 1.0) / 2.0


class Lagrange:
    """The Lagrange basis on `nodes`: values and first derivatives."""

    def __init__(self, nodes):
        self.nodes = np.asarray(nodes, np.float64)

    def values(self, x) -> np.ndarray:
        """(len(x), n): phi_j(x_q)."""
        x = np.atleast_1d(np.asarray(x, np.float64))
        z = self.nodes
        out = np.ones((x.size, z.size))
        for j in range(z.size):
            for m in range(z.size):
                if m != j:
                    out[:, j] *= (x - z[m]) / (z[j] - z[m])
        return out

    def derivatives(self, x) -> np.ndarray:
        """(len(x), n): phi_j'(x_q)."""
        x = np.atleast_1d(np.asarray(x, np.float64))
        z = self.nodes
        out = np.zeros((x.size, z.size))
        for j in range(z.size):
            for l in range(z.size):
                if l == j:
                    continue
                term = np.full(x.size, 1.0 / (z[j] - z[l]))
                for m in range(z.size):
                    if m not in (j, l):
                        term *= (x - z[m]) / (z[j] - z[m])
                out[:, j] += term
        return out


def q_nodes(k: int) -> np.ndarray:
    """Support points of continuous Q_k on one cell: Gauss-Lobatto."""
    return gauss_lobatto_points(k + 1)


def fe_matrices_1d(n_cells: int, k: int, length: float = 1.0):
    """Dense global (M, K) of continuous Q_k on n_cells equal cells of a
    segment: M_ij = int phi_i phi_j, K_ij = int phi_i' phi_j', by
    (k + 1)-point Gauss per cell (exact for both)."""
    h = length / n_cells
    basis = Lagrange(q_nodes(k))
    xq, wq = gauss(k + 1)
    V, D = basis.values(xq), basis.derivatives(xq)
    m_loc = h * (V.T * wq) @ V
    k_loc = (D.T * wq) @ D / h
    n = n_cells * k + 1
    M, K = np.zeros((n, n)), np.zeros((n, n))
    for c in range(n_cells):
        s = slice(c * k, c * k + k + 1)
        M[s, s] += m_loc
        K[s, s] += k_loc
    return M, K


def node_coordinates_1d(n_cells: int, k: int, lower: float = 0.0,
                        length: float = 1.0) -> np.ndarray:
    """The n_cells k + 1 global nodes of the segment, in order."""
    h = length / n_cells
    z = q_nodes(k)
    pts = [lower + (c + z[a]) * h for c in range(n_cells)
           for a in range(k if c < n_cells - 1 else k + 1)]
    return np.asarray(pts)


def load_vector_1d(fn, n_cells: int, k: int, n_q: int, lower: float = 0.0,
                   length: float = 1.0) -> np.ndarray:
    """b_i = int fn(x) phi_i(x) dx by n_q-point Gauss on every cell."""
    h = length / n_cells
    basis = Lagrange(q_nodes(k))
    xq, wq = gauss(n_q)
    V = basis.values(xq)
    b = np.zeros(n_cells * k + 1)
    for c in range(n_cells):
        f = fn(lower + (c + xq) * h)
        b[c * k:c * k + k + 1] += h * (V.T @ (wq * f))
    return b


class DGTime:
    """dG(r) in time on one reference step [0, 1]: a Lagrange basis on the
    r + 1 right Radau points.  For a step of length tau the weak form
    int (u_t, v) + a(u, v) dt + (u(t+) - u(t-), v(t+)) = int (f, v) dt
    gives, per step,
        mass[i, j]     = int phi_i phi_j          (times tau, with K)
        der_jump[i, j] = int phi_i phi_j' + phi_i(0) phi_j(0)   (with M)
        coupling[i, j] = phi_i(0) phi_j(1)  (the previous step's end)
    and the force's time rule is the interpolatory one on the nodes."""

    def __init__(self, r: int):
        self.r = r
        self.nodes = radau_right_points(r + 1)
        basis = Lagrange(self.nodes)
        xq, wq = gauss(r + 2)
        V, D = basis.values(xq), basis.derivatives(xq)
        v0, v1 = basis.values(0.0)[0], basis.values(1.0)[0]
        self.mass = (V.T * wq) @ V
        self.der_jump = (V.T * wq) @ D + np.outer(v0, v0)
        self.coupling = np.outer(v0, v1)
        self.start = v0
        self.end = v1
        self.weights = V.T @ wq      # int phi_j over the step
