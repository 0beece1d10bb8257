"""The plain reference of one Gibbs iteration of the Gaussian NNGP sampler
(mcmc_nngp_update_Gaussian.R, with the sampler's stated adaptive steps),
for a batch of rows, each a copy of one chain.

One iteration, in the reference's order: ``covparams_steps`` pairs of
(ancillary MH on (log_scale, shape) with the whitened field fixed,
sufficient MH with the field fixed); the step-size adaptation and the
adaptive-covariance moments; the conjugate (beta_0, beta) draw with the
interweaved redraw of the location coefficients; ``n_chromatic`` chromatic
Gibbs sweeps of the field; ten MH steps on the noise variance.  The factor
build, the triangular solve, Q = L'L and the sweeps are textbook plain
tensor code: an unrolled Cholesky of each neighbour set, a level-by-level
substitution, index-add sums, colour-by-colour updates.

The MH decisions on (log_scale, shape) follow the sampler's: the caller
infers them from what it recorded (``Rows.forced``), and each decision
that the reference's own arithmetic in ``dtype`` takes the other way is
counted with its margin, the least change of the log ratio or of the
support's slack that would make the reference agree (``Rows.margin``).
Where a noise step's log ratio lies within ``tie`` of its log-uniform,
rounding in a lower precision may decide either way; with ``branch`` such
a row is split into both outcomes (``Rows.ties`` counts them) and the
caller keeps, for each chain, the row that matches the record.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark.reference.bessel import _beschb, kv

NOISE_STEPS = 10
ADAPT_WINDOW = 25
ADAPT_UNTIL = 2000
AM_MIN_COUNT = 100.0
STATE_KEYS = ("beta_0", "beta", "log_scale", "log_noise_variance", "shape",
              "field", "tk_ancillary", "tk_sufficient", "prop_mean",
              "prop_m2", "prop_count")


def shape_names(covfun):
    return ["log_range"] + (["qlogis_smoothness"]
                            if covfun.startswith("matern") else [])


def natural(covfun, shape):
    """Sampled shape [R, ns] -> (range, nu): exp, 0.5 + 0.5 sigmoid."""
    cols = [torch.exp(shape[:, 0])]
    if covfun.startswith("matern"):
        cols.append(0.5 + 0.5 * torch.sigmoid(shape[:, 1]))
    return torch.stack(cols, 1)


def _matern(d, nu):
    """Matérn correlation at scaled distance d: 1 - the ascending series
    for d <= 0.29, 2^(1-nu)/Gamma(nu) d^nu K_nu(d) beyond, 1 at d <= 1e-8."""
    safe = torch.clamp_min(d, 1e-8)
    lognorm = (1.0 - nu) * math.log(2.0) - torch.lgamma(nu)
    big = torch.exp(lognorm + nu * torch.log(safe)) * kv(nu, safe)
    x = torch.clamp_max(safe, 0.29)
    mu = 1.0 - nu
    _, _, gampl, gammi = _beschb(mu)
    g = gammi / (mu * (1.0 - mu) * gampl)
    q = 0.25 * x * x
    t2 = torch.ones_like(x)
    S2 = t2
    t1 = q / (1.0 - nu)
    S1 = t1
    for k in range(1, 6):
        t2 = t2 * q / (k * (k + nu))
        S2 = S2 + t2
        if k >= 2:
            t1 = t1 * q / (k * (k - nu))
            S1 = S1 + t1
    small = 1.0 - (g * torch.exp(2.0 * nu * torch.log(
        torch.clamp_min(0.5 * x, 1e-30))) * S2 - S1)
    val = torch.where(safe <= 0.29, small, big)
    return torch.where(d <= 1e-8, torch.ones_like(val), val)


@dataclass
class Rows:
    """Rows of chain states: ``s`` {leaf: [R, ...]}, the factor ``linv``
    [R, n, m+1], the acceptance counts, the chain ``owner`` of each row,
    the ties split so far, the sampler's (log_scale, shape) decisions of
    the iteration (``forced`` [R, steps] or None) and the reference's
    disagreements with them: their count and largest margin."""

    s: dict
    linv: torch.Tensor
    acc_anc: torch.Tensor
    acc_suf: torch.Tensor
    owner: torch.Tensor
    ties: int = 0
    forced: torch.Tensor | None = None
    disagree: int = 0
    margin: float = 0.0
    notes: list = field(default_factory=list)

    def take(self, idx):
        return Rows({k: None if v is None else v[idx]
                     for k, v in self.s.items()}, self.linv[idx],
                    self.acc_anc[idx], self.acc_suf[idx], self.owner[idx],
                    self.ties, None if self.forced is None
                    else self.forced[idx], self.disagree, self.margin,
                    self.notes)


@dataclass
class Model:
    covfun: str
    n: int
    m: int
    xyz_np: np.ndarray
    NN: torch.Tensor          # [n, k] int64, padding -> 0
    mask: torch.Tensor        # [n, k]
    d2_pairs: torch.Tensor    # [n, P] float64 squared chordal distances
    pair_valid: torch.Tensor  # [n, P] both positions real
    levels: list              # row index tensors, in topological order
    nn_flat: torch.Tensor     # [n k] targets of the rows' entries (pad n)
    pair_a: torch.Tensor
    pair_b: torch.Tensor
    pair_edge: torch.Tensor   # [n, P] edge id (pad E)
    n_edges: int
    colours: list             # (sites, entry row in colour, entry col, edge)
    locs_match: torch.Tensor
    obs_per_loc: torch.Tensor
    y: torch.Tensor
    X: torch.Tensor
    X_locs_u: torch.Tensor
    solve_1XT1X: torch.Tensor
    chol_1XT1X: torch.Tensor
    var_y: float
    range_cap: float
    range_floor: float
    d_floor: float
    dtype: torch.dtype = torch.float64
    field_dtype: torch.dtype | None = None   # the state's field precision
    sum_dtype: torch.dtype = torch.float64   # the MH sums' precision

    @classmethod
    def build(cls, covfun, xyz, NN, edges, colours, levels, locs_match, y,
              X, X_locs_u, solve_1XT1X, chol_1XT1X, device):
        n, k = NN.shape
        dev = torch.device(device)
        f64 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                        device=dev)
        i64 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64),
                                        device=dev)
        valid = NN >= 0
        safe = np.maximum(NN, 0)
        pts = xyz[safe]
        d2 = ((pts[:, :, None] - pts[:, None]) ** 2).sum(-1)
        has_parent = valid[:, 1]
        near = np.sqrt(d2[has_parent, 0, 1])
        near = near[near > 0]
        E = len(edges)
        pa, pb = np.triu_indices(k, 1)
        pair_edge = np.full((n, len(pa)), E, dtype=np.int64)
        for j, (a, b) in enumerate(zip(pa, pb)):
            r, c = NN[:, a], NN[:, b]
            ok = (r >= 0) & (c >= 0)
            lo, hi = np.minimum(r, c)[ok], np.maximum(r, c)[ok]
            key = lo * n + hi
            ekey = edges[:, 0] * n + edges[:, 1]
            pair_edge[ok, j] = np.searchsorted(ekey, key)
        # directed entries of the moralized graph, by colour of their row
        rows = np.concatenate([edges[:, 0], edges[:, 1]])
        cols = np.concatenate([edges[:, 1], edges[:, 0]])
        eidx = np.concatenate([np.arange(E), np.arange(E)])
        col_list = []
        for c in range(int(colours.max()) + 1):
            sites = np.flatnonzero(colours == c)
            pos = np.full(n, -1, dtype=np.int64)
            pos[sites] = np.arange(len(sites))
            sel = pos[rows] >= 0
            col_list.append((i64(sites), i64(pos[rows[sel]]), i64(cols[sel]),
                             i64(eidx[sel])))
        lv = [i64(np.flatnonzero(levels == L)) for L in range(levels.max() + 1)]
        bbox = xyz.max(0) - xyz.min(0)
        matern = covfun.startswith("matern")
        return cls(
            covfun=covfun, n=n, m=k - 1, xyz_np=xyz, NN=i64(safe),
            mask=f64(valid), d2_pairs=f64(d2[:, pa, pb]),
            pair_valid=f64(valid[:, pa] & valid[:, pb]), levels=lv,
            nn_flat=i64(np.where(valid, NN, n).reshape(-1)),
            pair_a=i64(pa), pair_b=i64(pb), pair_edge=i64(pair_edge),
            n_edges=E, colours=col_list, locs_match=i64(locs_match),
            obs_per_loc=f64(np.bincount(locs_match, minlength=n)), y=f64(y),
            X=f64(X), X_locs_u=f64(X_locs_u), solve_1XT1X=f64(solve_1XT1X),
            chol_1XT1X=f64(chol_1XT1X), var_y=float(np.var(y, ddof=1)),
            range_cap=4.0 * float(np.sqrt((bbox ** 2).sum())),
            range_floor=float(np.sqrt(np.median(near ** 2))) / 100.0,
            d_floor=1e-5 if matern else 1e-12)

    # --- precision ---------------------------------------------------
    def t(self, x):
        return x.to(self.dtype)

    def sum(self, x, dim=-1):
        """A sum in the MH sums' precision."""
        return x.to(self.sum_dtype).sum(dim).to(self.dtype)

    def store_field(self, w):
        if self.field_dtype is None:
            return w
        return w.to(self.field_dtype).to(self.dtype)

    # --- factor ------------------------------------------------------
    def factor(self, nat, chunk=32):
        """Compressed inverse-Cholesky rows [R, n, m+1] of natural shape
        params [R, ns]."""
        return torch.cat([self._factor(nat[i:i + chunk])
                          for i in range(0, nat.shape[0], chunk)])

    def _factor(self, nat):
        dt, m = self.dtype, self.m
        if m == 0:
            return torch.ones(nat.shape[0], self.n, 1, dtype=dt,
                              device=nat.device)
        rng = nat[:, 0].to(dt)
        d = torch.sqrt(torch.clamp_min(
            self.d2_pairs.to(dt)[None] / (rng * rng)[:, None, None], 0.0))
        if self.covfun.startswith("matern"):
            corr = _matern(d, nat[:, 1].to(dt)[:, None, None])
        else:
            corr = torch.exp(-d)
        corr = corr * self.pair_valid.to(dt)     # padded pairs: identity
        index = {(int(a), int(b)): j for j, (a, b) in
                 enumerate(zip(self.pair_a.tolist(), self.pair_b.tolist()))}
        K = lambda a, b: corr[..., index[(min(a, b), max(a, b))]]
        L = [[None] * m for _ in range(m)]
        for j in range(m):
            s = 1.0
            for t in range(j):
                s = s - L[j][t] * L[j][t]
            L[j][j] = torch.sqrt(torch.clamp_min(torch.as_tensor(
                s, dtype=dt, device=nat.device), 1e-12))
            for i in range(j + 1, m):
                s = K(1 + i, 1 + j)
                for t in range(j):
                    s = s - L[i][t] * L[j][t]
                L[i][j] = s / L[j][j]
        u = []
        for i in range(m):
            s = K(1 + i, 0)
            for t in range(i):
                s = s - L[i][t] * u[t]
            u.append(s / L[i][i])
        dv = torch.clamp_min(1.0 - sum(ui * ui for ui in u), self.d_floor)
        b = [None] * m
        for i in range(m - 1, -1, -1):
            s = u[i]
            for t in range(i + 1, m):
                s = s - L[t][i] * b[t]
            b[i] = s / L[i][i]
        isd = 1.0 / torch.sqrt(dv)
        mask = self.mask.to(dt)
        return torch.stack([isd] + [-b[j] * isd * mask[:, 1 + j]
                                    for j in range(m)], -1)

    # --- L products and solves ---------------------------------------
    def lmult(self, linv, x):
        """L x per row: x [R, n] -> [R, n]."""
        return (linv * x[:, self.NN] * self.mask).sum(-1)

    def lmult_cols(self, linv, x):
        """L x for x [n, c] shared by the rows: [R, n, c]."""
        return torch.stack([self.lmult(linv, x[:, j].expand(linv.shape[0],
                                                            -1))
                            for j in range(x.shape[1])], -1)

    def solve(self, linv, v):
        """x with L x = v per row, level by level."""
        x = torch.zeros_like(v)
        for rows in self.levels:
            lv = linv[:, rows]
            par = x[:, self.NN[rows, 1:]]
            acc = (lv[..., 1:] * self.mask[rows, 1:] * par).sum(-1)
            x[:, rows] = (v[:, rows] - acc) / lv[..., 0]
        return x

    def q_values(self, linv):
        """(diag(Q) [R, n], Q on each moralized edge [R, E]) of Q = L'L."""
        R = linv.shape[0]
        lm = linv * self.mask
        pdiag = torch.zeros(R, self.n + 1, dtype=linv.dtype,
                            device=linv.device)
        pdiag.index_add_(1, self.nn_flat, (lm * lm).reshape(R, -1))
        prods = lm[:, :, self.pair_a] * lm[:, :, self.pair_b]
        q = torch.zeros(R, self.n_edges + 1, dtype=linv.dtype,
                        device=linv.device)
        q.index_add_(1, self.pair_edge.reshape(-1), prods.reshape(R, -1))
        return pdiag[:, :self.n], q[:, :self.n_edges]

    # --- blocks --------------------------------------------------------
    def mu(self, s):
        return s["beta_0"][:, None] + s["beta"] @ self.t(self.X).T

    def proposal_chol(self, s):
        if s["prop_mean"] is None:
            return None
        d = s["prop_mean"].shape[1]
        eye = torch.eye(d, dtype=self.dtype, device=s["prop_mean"].device)
        cnt = s["prop_count"][:, None, None]
        cov = s["prop_m2"] / torch.clamp_min(cnt - 1.0, 1.0)
        tr = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1)[:, None, None] / d
        covn = 0.85 * (cov / torch.clamp_min(tr, 1e-30)) + 0.15 * eye
        L, info = torch.linalg.cholesky_ex(covn)
        use = ((s["prop_count"] >= AM_MIN_COUNT) & (info == 0)
               & torch.isfinite(L).all(-1).all(-1))
        return torch.where(use[:, None, None], L, eye)

    def propose(self, s, tk, z):
        C = self.proposal_chol(s)
        if C is not None:
            z = (C @ z[..., None])[..., 0]
        innov = z * torch.exp(0.5 * tk)[:, None]
        new_ls = s["log_scale"] + innov[:, 0]
        new_shape = s["shape"] + innov[:, 1:]
        return new_ls, new_shape, natural(self.covfun, new_shape)

    def support(self, new_ls, new_shape, nat):
        """(inside the support box [R], the least slack of its bounds in
        log units [R])."""
        lr, lv = torch.log(nat[:, 0]), math.log(self.var_y)
        slack = [math.log(self.range_cap) - lr, lr - math.log(self.range_floor),
                 new_ls - (lv - 18.42), lv - new_ls]
        if self.covfun.startswith("matern"):
            slack.append(6.0 - new_shape[:, 1].abs())
        ok = (nat[:, 0] <= self.range_cap) & (nat[:, 0] >= self.range_floor)
        if self.covfun.startswith("matern"):
            ok = ok & (new_shape[:, 1].abs() <= 6.0)
        ok = ok & (new_ls > lv - 18.42) & (torch.exp(new_ls) < self.var_y)
        return ok, torch.stack(slack).amin(0)

    def _follow(self, rows, cand, ratio, logu, ok, slack, step):
        """The sampler's decision of ``step``, with the reference's own
        disagreements counted, their largest margin kept and each
        described in ``rows.notes``."""
        mine = ok & (ratio > logu)
        forced = rows.forced[:, step]
        gap = ratio - logu
        margin = torch.where(mine, torch.minimum(gap, slack),
                             torch.clamp_min(torch.maximum(-slack, -gap), 0))
        dis = mine != forced
        if bool(dis.any()):
            rows.disagree += int(dis.sum())
            rows.margin = max(rows.margin, float(margin[dis].max()))
            nat = natural(self.covfun, cand["shape"])
            for i in torch.nonzero(dis)[:, 0].tolist():
                rows.notes.append(
                    f"chain {int(rows.owner[i])} step {step}: sampler "
                    f"{'accepted' if bool(forced[i]) else 'rejected'}; "
                    f"reference log ratio {float(ratio[i]):.6g}, log u "
                    f"{float(logu[i]):.6g}, support slack "
                    f"{float(slack[i]):.4g}; proposal log_scale "
                    f"{float(cand['log_scale'][i]):.6g}, natural shape "
                    f"{[round(float(v), 6) for v in nat[i]]}, largest "
                    f"1/sqrt(d) {float(cand['linv'][i, :, 0].max()):.6g}, "
                    f"current {float(rows.linv[i, :, 0].max()):.6g}")
        return forced

    def decide(self, rows, cand, ratio, logu, support, tie, branch, cap,
               step=None):
        """Apply an MH decision: cand {leaf or "linv": [R, ...]} replaces
        the rows' values where accepted.  A ``step`` of the sampler's
        recorded decisions is followed; otherwise a tie is split under
        ``branch``.  Returns (rows, accept [R])."""
        ok, slack = support
        acc = ok & (ratio > logu)
        if step is not None and rows.forced is not None:
            acc = self._follow(rows, cand, ratio, logu, ok, slack, step)
        elif branch:
            near = torch.nonzero(ok & ((ratio - logu).abs() < tie))[:, 0]
            if len(near) and rows.owner.shape[0] + len(near) <= cap:
                idx = torch.cat([torch.arange(len(acc), device=acc.device),
                                 near])
                ties = rows.ties + len(near)
                rows = rows.take(idx)
                rows.ties = ties
                cand = {k: v[idx] for k, v in cand.items()}
                acc = torch.cat([acc, ~acc[near]])
        for k, v in cand.items():
            a = acc.reshape(acc.shape + (1,) * (v.dim() - 1))
            if k == "linv":
                rows.linv = torch.where(a, v, rows.linv)
            else:
                rows.s[k] = torch.where(a, v, rows.s[k])
        return rows, acc.to(self.dtype)

    def ancillary(self, rows, z, u, tie, branch, cap, step=None):
        s = rows.s
        new_ls, new_shape, nat = self.propose(s, s["tk_ancillary"], z)
        new_linv = self.factor(nat)
        b0 = s["beta_0"][:, None]
        v = self.lmult(rows.linv, s["field"] - b0)
        new_field = b0 + torch.exp(0.5 * (new_ls - s["log_scale"]))[:, None] \
            * self.solve(new_linv, v)
        new_field = self.store_field(new_field)
        mu = self.mu(s)
        delta = (new_field - s["field"])[:, self.locs_match]
        r_old = self.t(self.y) - s["field"][:, self.locs_match] - mu + b0
        llr = -0.5 * torch.exp(-s["log_noise_variance"]) * self.sum(
            delta * (delta - 2.0 * r_old))
        cand = {"log_scale": new_ls, "shape": new_shape, "linv": new_linv,
                "field": new_field}
        return self.decide(rows, cand, llr, torch.log(u),
                           self.support(new_ls, new_shape, nat), tie,
                           branch, cap, step)

    def sufficient(self, rows, z, u, tie, branch, cap, step=None):
        s = rows.s
        new_ls, new_shape, nat = self.propose(s, s["tk_sufficient"], z)
        new_linv = self.factor(nat)
        w0 = s["field"] - s["beta_0"][:, None]
        zn, zo = self.lmult(new_linv, w0), self.lmult(rows.linv, w0)
        a, b = new_linv[..., 0], rows.linv[..., 0]
        terms = (torch.log1p((a - b) / b)
                 - 0.5 * (zn * zn * torch.exp(-new_ls)[:, None]
                          - zo * zo * torch.exp(-s["log_scale"])[:, None]))
        ratio = self.sum(terms) - 0.5 * self.n * (new_ls - s["log_scale"])
        cand = {"log_scale": new_ls, "shape": new_shape, "linv": new_linv}
        return self.decide(rows, cand, ratio, torch.log(u),
                           self.support(new_ls, new_shape, nat), tie,
                           branch, cap, step)

    def adapt_and_am(self, rows, it, iter_start, K, adapt_z):
        s = rows.s
        am = (torch.zeros_like(s["log_scale"], dtype=torch.bool)
              if s["prop_mean"] is None else s["prop_count"] >= AM_MIN_COUNT)
        if (it + 1) % ADAPT_WINDOW == 0:
            window = ADAPT_WINDOW * K
            if iter_start <= ADAPT_UNTIL:
                lo = torch.where(am, 0.15, 0.05)
                hi = torch.where(am, 0.35, 0.15)
                for key, acc, mean_step, col in (
                        ("tk_ancillary", rows.acc_anc, 0.4, 0),
                        ("tk_sufficient", rows.acc_suf, 0.2, 1)):
                    rate = acc / window
                    step = mean_step + 0.05 * adapt_z[:, col]
                    tk = s[key]
                    s[key] = torch.clamp(torch.where(
                        rate < lo, tk - step,
                        torch.where(rate > hi, tk + step, tk)), -30.0, 6.0)
            rows.acc_anc = torch.zeros_like(rows.acc_anc)
            rows.acc_suf = torch.zeros_like(rows.acc_suf)
        if s["prop_mean"] is not None:
            x = torch.cat([s["log_scale"][:, None], s["shape"]], 1)
            if iter_start + it in (ADAPT_UNTIL // 2, ADAPT_UNTIL):
                s["prop_mean"] = x
                s["prop_m2"] = torch.zeros_like(s["prop_m2"])
                s["prop_count"] = torch.ones_like(s["prop_count"])
            else:
                cnt = s["prop_count"] + 1.0
                delta = x - s["prop_mean"]
                mean = s["prop_mean"] + delta / cnt[:, None]
                s["prop_m2"] = s["prop_m2"] + delta[:, :, None] * (
                    x - mean)[:, None, :]
                s["prop_mean"], s["prop_count"] = mean, cnt
        return rows

    def beta_step(self, rows, beta_z, locs_z):
        s = rows.s
        dt, dev = self.dtype, s["field"].device
        field, beta = s["field"], s["beta"]
        R, n = field.shape
        pl = self.X_locs_u.shape[1]
        X = self.t(self.X)
        r = self.t(self.y) - field[:, self.locs_match] + s["beta_0"][:, None]
        rX1 = torch.cat([r.sum(-1, keepdim=True), r @ X], 1)
        innov = rX1 @ self.t(self.solve_1XT1X) + torch.exp(
            0.5 * s["log_noise_variance"])[:, None] * (
            beta_z @ self.t(self.chol_1XT1X).T)
        field = field - s["beta_0"][:, None] + innov[:, :1]
        beta_0, beta = innov[:, 0], innov[:, 1:]
        X1l = torch.cat([torch.ones(n, 1, dtype=dt, device=dev),
                         self.t(self.X_locs_u)], 1)
        LX = self.lmult_cols(rows.linv, X1l)
        P = LX.transpose(1, 2) @ LX
        cL, _ = torch.linalg.cholesky_ex(P)
        other = field + beta[:, :pl] @ self.t(self.X_locs_u).T
        t = LX.transpose(1, 2) @ self.lmult(rows.linv, other)[..., None]
        mean = torch.cholesky_solve(t, cL)[..., 0]
        noise = torch.linalg.solve_triangular(
            cL.transpose(1, 2), locs_z[..., None], upper=True)[..., 0]
        innov = mean + torch.exp(0.5 * s["log_scale"])[:, None] * noise
        beta = beta.clone()
        beta[:, :pl] = innov[:, 1:]
        s["beta_0"], s["beta"] = innov[:, 0], beta
        s["field"] = self.store_field(other - innov[:, 1:] @ self.t(
            self.X_locs_u).T)
        return rows

    def sweeps(self, rows, noise):
        s = rows.s
        R = s["field"].shape[0]
        pdiag, q = self.q_values(rows.linv)
        mu = self.mu(s)
        rs = torch.zeros(R, self.n, dtype=self.dtype, device=q.device)
        rs.index_add_(1, self.locs_match, self.t(self.y) - mu)
        inv_scale = torch.exp(-s["log_scale"])[:, None]
        inv_noise = torch.exp(-s["log_noise_variance"])[:, None]
        P = inv_scale * pdiag + inv_noise * self.obs_per_loc.to(self.dtype)
        b0 = s["beta_0"][:, None]
        w = s["field"].clone()
        for k in range(noise.shape[1]):
            for sites, pos, cols, edge in self.colours:
                prior = torch.zeros(R, len(sites), dtype=self.dtype,
                                    device=w.device)
                prior.index_add_(1, pos, q[:, edge] * (w[:, cols] - b0))
                Ps = P[:, sites]
                mean = b0 - (inv_scale * prior - inv_noise * rs[:, sites]) / Ps
                w[:, sites] = self.store_field(
                    mean + noise[:, k, sites] / torch.sqrt(Ps))
        s["field"] = w
        return rows

    def noise_steps(self, rows, z, u, tie, branch, cap):
        s = rows.s
        r = (self.t(self.y) - s["field"][:, self.locs_match] - self.mu(s)
             + s["beta_0"][:, None])
        s["sse"] = self.sum(r * r)
        n_obs = self.y.shape[0]
        for i in range(NOISE_STEPS):
            s = rows.s
            lnv = s["log_noise_variance"]
            innov = z[rows.owner, i] * 0.01
            ratio = (-0.5 * n_obs * innov
                     - 0.5 * s["sse"] * torch.exp(-lnv) * torch.expm1(-innov))
            ok = torch.exp(lnv + innov) < self.var_y
            slack = math.log(self.var_y) - (lnv + innov)
            rows, _ = self.decide(rows, {"log_noise_variance": lnv + innov},
                                  ratio, torch.log(u[rows.owner, i]),
                                  (ok, slack), tie, branch, cap)
        del rows.s["sse"]
        return rows

    def innovations(self, rows, draws, K):
        """[R, 2K, d] (log_scale, shape) moves of the iteration's proposals,
        in order (ancillary, sufficient) K times: fixed by the state at the
        iteration's start (step sizes, the AM factor) and the draws."""
        s = rows.s
        C = self.proposal_chol(s)
        out = []
        for rep in range(K):
            for key, tk in (("anc_z", s["tk_ancillary"]),
                            ("suf_z", s["tk_sufficient"])):
                z = draws[key][rows.owner][:, rep].to(self.dtype)
                if C is not None:
                    z = (C @ z[..., None])[..., 0]
                out.append(z * torch.exp(0.5 * tk)[:, None])
        return torch.stack(out, 1)

    def iteration(self, rows, draws, it, iter_start, K, S, tie=0.0,
                  branch=False, cap=0):
        """One Gibbs iteration of every row; ``draws`` {field: [C, ...]}
        are indexed by the rows' owners; ``rows.forced`` [R, 2K], when
        given, are the (log_scale, shape) decisions to follow."""
        o = lambda k: draws[k][rows.owner].to(self.dtype)
        for rep in range(K):
            rows, a = self.ancillary(rows, o("anc_z")[:, rep],
                                     o("anc_u")[:, rep], tie, branch, cap,
                                     2 * rep)
            rows.acc_anc = rows.acc_anc + a
            rows, a = self.sufficient(rows, o("suf_z")[:, rep],
                                      o("suf_u")[:, rep], tie, branch, cap,
                                      2 * rep + 1)
            rows.acc_suf = rows.acc_suf + a
        rows = self.adapt_and_am(rows, it, iter_start, K, o("adapt_z"))
        rows = self.beta_step(rows, o("beta_z"), o("locs_z"))
        rows = self.sweeps(rows, o("sweep_z")[:, :S])
        return self.noise_steps(rows, draws["noise_z"].to(self.dtype),
                                draws["noise_u"].to(self.dtype), tie,
                                branch, cap)

    def rows_of(self, state: dict, device):
        """Rows (one a chain) from a chain state {leaf: array [C, ...]}:
        the factor rebuilt from the shapes, as a cycle starts."""
        s = {k: (None if state.get(k) is None else torch.as_tensor(
            np.asarray(state[k]), device=device).to(self.dtype))
            for k in STATE_KEYS}
        C = s["field"].shape[0]
        zero = torch.zeros(C, dtype=self.dtype, device=device)
        return Rows(s, self.factor(natural(self.covfun, s["shape"])), zero,
                    zero.clone(), torch.arange(C, device=device))
