"""The whole backward sweep as one Pallas kernel for NVIDIA GPUs (Triton).

Under `vmap` the scan form of the sweep (`backward._run_pass`, reference:
src/backward_pass.jl:58-189) is a reverse `lax.scan` over T stages whose
body factors a small KKT matrix column by column: on a GPU that is several
small fusions per column, per stage and per reg-ladder restart, each far
too small to fill the card. This kernel runs the entire reverse-time
recursion in one launch:

  * the grid runs over tiles of `tile_b` problem instances only; each
    program walks the T stages itself in a `lax.fori_loop` whose carry is
    the value function (Vx, Vxx), the expected decrease dL and the
    fail / singular-at-first-failure flags;
  * one lane per instance: every matrix entry is a `[tile_b]` vector;
  * the stage's KKT matrix, its factors and the right-hand sides live in a
    per-program scratch buffer (an extra output, L1/L2-resident), walked by
    loops over rows and columns. Written out entry by entry, the stage
    would be tens of thousands of operations, which the Triton compiler
    cannot take in reasonable time; the loops keep the kernel small;
  * per-instance pivots make the column reads gathers and the solution
    writes scatters within the program's own scratch;
  * inputs are packed tile-major, `[n_tiles, T, entries * tile_b]`, so an
    entry's lane vector is one coalesced load; the batch is padded to whole
    tiles;
  * the same kernel serves f32 (the bulk phase) and f64 (the endgame).

Arithmetic matches the scan path up to floating-point reassociation: the
same max-|diagonal| pivot order (`ops.ldlt.ldlt_factor_pivoted`, ties
broken by the lowest original row), the same refinement count, the same
backward-stability residual gate and the same fail/singular bookkeeping.
The closed-form bound-dual gains (reference: src/backward_pass.jl:152-172)
are elementwise in the solved gains and are formed by the wrapper in XLA.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


def _layout(nx, nu, nc, has_sec):
    """Static entry offsets of the per-stage input pack: name -> (offset,
    shape). The order is the order the wrapper concatenates in."""
    shapes = [("fx", (nx, nx)), ("fu", (nx, nu)), ("lx", (nx,)),
              ("lu", (nu,)), ("lxx", (nx, nx)), ("lux", (nu, nx)),
              ("luu", (nu, nu))]
    if nc:
        shapes += [("cx", (nc, nx)), ("cu", (nc, nu)), ("c", (nc,)),
                   ("phi", (nc,))]
    if has_sec:
        shapes += [("sxx", (nx, nx)), ("sux", (nu, nx)), ("suu", (nu, nu))]
    shapes += [("il", (nu,)), ("iu", (nu,)), ("zl", (nu,)), ("zu", (nu,))]
    layout, off = {}, 0
    for name, shp in shapes:
        layout[name] = (off, shp)
        n = 1
        for d in shp:
            n *= d
        off += n
    return layout, off


def _flat_index(shape, idx):
    flat = 0
    for d, i in zip(shape, idx):
        flat = flat * d + i
    return flat


def sum_terms(terms):
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def _scratch_layout(m, nk):
    """Row offsets of the per-program scratch regions (each row is one
    `[tile_b]` lane vector)."""
    sizes = [("A", m * m), ("K0", m * m), ("L", m * m), ("D", m),
             ("RB", m * nk), ("RES", m * nk), ("Z", m * nk), ("X", m * nk),
             ("DX", m * nk), ("R", m * nk)]
    out, off = {}, 0
    for name, n in sizes:
        out[name] = off
        off += n
    return out, off


def _kernel(head_ref, w_ref, x_ref, dl_ref, flag_ref, scr_ref, piv_ref, *,
            T, tile_b, nx, nu, nc, has_sec, refine, rtol, layout):
    """One program: `tile_b` instances, all T stages. Refs are tile-major
    (`[n_tiles, ..., entries * tile_b]`), so a lane vector of entry e is
    the contiguous slice `e * tile_b + lane`; a per-lane entry index makes
    the same expression a gather or scatter."""
    m, nk = nu + nc, nx + 1
    pid = pl.program_id(0)
    lane = jnp.arange(tile_b, dtype=jnp.int32)
    S, _ = _scratch_layout(m, nk)
    loop = jax.lax.fori_loop

    def each(n, f):
        """for i in range(n): f(i), as one loop (no unrolling)."""
        loop(0, n, lambda i, c: (f(i), c)[1], ())

    def at(e):
        return e * tile_b + lane

    def sld(e):
        return plgpu.load(scr_ref.at[pid, at(e)])

    def sst(e, v):
        plgpu.store(scr_ref.at[pid, at(e)], v)

    def hld(e):
        return plgpu.load(head_ref.at[pid, at(e)])

    mu, reg, dc = hld(0), hld(1), hld(2)
    dt = mu.dtype
    zero = jnp.zeros_like(mu)
    Vx0 = [hld(3 + i) for i in range(nx)]
    Vxx0 = [[hld(3 + nx + i * nx + j) for j in range(nx)]
            for i in range(nx)]

    def n_rows(rows):
        return sum_terms([v * v for v in rows])

    def stage(t, Vx, Vxx):
        def w(name, *idx):
            off, shp = layout[name]
            return plgpu.load(w_ref.at[pid, t, at(off + _flat_index(shp,
                                                                   idx))])

        # --- KKT assembly: K = [H cu'; cu -dc I], rhs = -[Qu B; c cx] ---
        fx = [[w("fx", i, j) for j in range(nx)] for i in range(nx)]
        fxV = [[sum_terms([fx[k][i] * Vxx[k][l] for k in range(nx)])
                for l in range(nx)] for i in range(nx)]
        C = [[w("lxx", i, j) + sum_terms([fxV[i][l] * fx[l][j]
                                          for l in range(nx)])
              for j in range(nx)] for i in range(nx)]
        if has_sec:
            C = [[C[i][j] + w("sxx", i, j) for j in range(nx)]
                 for i in range(nx)]

        def u_row(a, norms):
            nK, nB = norms
            fu_a = [w("fu", k, a) for k in range(nx)]
            fuV = [sum_terms([fu_a[k] * Vxx[k][l] for k in range(nx)])
                   for l in range(nx)]
            sl = 1.0 / w("il", a)                # 0 where il = +inf
            su = 1.0 / w("iu", a)
            sig = w("zl", a) * sl + w("zu", a) * su
            qu = w("lu", a)
            for c in range(nc):
                qu = qu + w("cu", c, a) * w("phi", c)
            for k in range(nx):
                qu = qu + fu_a[k] * Vx[k]
            qu = qu - mu * sl + mu * su

            def h_entry(b, nK):
                h = w("luu", a, b)
                h = jnp.where(a == b, h + sig, h)
                h = h + sum_terms([fuV[l] * w("fu", l, b)
                                   for l in range(nx)])
                if has_sec:
                    h = h + w("suu", a, b)
                h = jnp.where(a == b, h + reg, h)
                sst(S["A"] + a * m + b, h)
                sst(S["K0"] + a * m + b, h)
                return nK + h * h

            nK = loop(0, nu, h_entry, nK)
            for c in range(nc):
                v = w("cu", c, a)
                for e in (a * m + nu + c, (nu + c) * m + a):
                    sst(S["A"] + e, v)
                    sst(S["K0"] + e, v)
                nK = nK + 2.0 * v * v
            row = [-qu]
            for j in range(nx):
                bm = w("lux", a, j) + sum_terms([fuV[l] * fx[l][j]
                                                 for l in range(nx)])
                if has_sec:
                    bm = bm + w("sux", a, j)
                row.append(-bm)
            for k, v in enumerate(row):
                sst(S["RB"] + a * nk + k, v)
            return nK, nB + n_rows(row)

        nK, nB = loop(0, nu, u_row, (zero, zero))
        for c in range(nc):
            for e in range(nc):
                v = -dc if c == e else zero
                sst(S["A"] + (nu + c) * m + nu + e, v)
                sst(S["K0"] + (nu + c) * m + nu + e, v)
                nK = nK + v * v
            row = [-w("c", c)] + [-w("cx", c, j) for j in range(nx)]
            for k, v in enumerate(row):
                sst(S["RB"] + (nu + c) * nk + k, v)
            nB = nB + n_rows(row)

        # --- pivoted LDL^T: symmetric max-|diagonal| pivots, first lowest
        # row on ties, NaN wins (jnp.argmax); implicit row masks ---
        def column(j, carry):
            elim, n_pos, n_zero, finite = carry

            def argmax(i, c):
                best, p = c
                cand = jnp.where(((elim >> i) & 1) == 1, -jnp.inf,
                                 jnp.abs(sld(S["A"] + i * (m + 1))))
                take = (cand > best) | (jnp.isnan(cand) & ~jnp.isnan(best))
                return (jnp.where(take, cand, best),
                        jnp.where(take, i, p))

            _, p = loop(0, m, argmax, (jnp.full_like(mu, -jnp.inf),
                                       jnp.zeros_like(lane)))
            plgpu.store(piv_ref.at[pid, at(j)], p)
            d = sld(S["A"] + p * (m + 1))
            sst(S["D"] + j, d)
            safe = jnp.where(d == 0.0, jnp.ones_like(d), d)
            elim = elim | (jnp.ones_like(p) << p)

            def l_entry(r):
                l = jnp.where(((elim >> r) & 1) == 1, zero,
                              sld(S["A"] + r * m + p) / safe)
                sst(S["L"] + j * m + r, l)

            each(m, l_entry)

            def update(r):
                dl = sld(S["L"] + j * m + r) * d

                def entry(k):
                    e = S["A"] + r * m + k
                    sst(e, sld(e) - dl * sld(S["L"] + j * m + k))

                each(m, entry)

            each(m, update)
            one, nil = jnp.int32(1), jnp.int32(0)
            return (elim, n_pos + jnp.where(d > 0.0, one, nil),
                    n_zero + jnp.where(d == 0.0, one, nil),
                    finite & jnp.isfinite(d))

        _, n_pos, n_zero, finite = loop(
            0, m, column, (jnp.zeros_like(lane), jnp.zeros_like(lane),
                           jnp.zeros_like(lane), jnp.ones_like(mu) > 0))

        def copy(src, dst):
            def body(r):
                for k in range(nk):
                    sst(dst + r * nk + k, sld(src + r * nk + k))
            each(m, body)

        def solve(src, dst):
            """dst = K^{-1} src from the factors (W z = b, W^T x = D^-1 z,
            W = P^T L)."""
            copy(src, S["RES"])

            def fwd(j):
                p = plgpu.load(piv_ref.at[pid, at(j)])
                z = [sld(S["RES"] + p * nk + k) for k in range(nk)]
                for k in range(nk):
                    sst(S["Z"] + j * nk + k, z[k])

                def upd(r):
                    l = sld(S["L"] + j * m + r)
                    for k in range(nk):
                        e = S["RES"] + r * nk + k
                        sst(e, sld(e) - l * z[k])

                each(m, upd)

            each(m, fwd)

            def clear(r):
                for k in range(nk):
                    sst(dst + r * nk + k, zero)

            each(m, clear)

            def bwd(jj):
                j = m - 1 - jj
                d = sld(S["D"] + j)
                safe = jnp.where(d == 0.0, jnp.ones_like(d), d)

                def acc(r, s):
                    l = sld(S["L"] + j * m + r)
                    return tuple(s[k] - l * sld(dst + r * nk + k)
                                 for k in range(nk))

                s = loop(0, m, acc, tuple(sld(S["Z"] + j * nk + k) / safe
                                         for k in range(nk)))
                p = plgpu.load(piv_ref.at[pid, at(j)])
                for k in range(nk):
                    sst(dst + p * nk + k, s[k])

            each(m, bwd)

        def residual(x):
            """R = rhs - K x; returns ||R||_F^2."""
            def row(i, nr):
                def acc(j, s):
                    kij = sld(S["K0"] + i * m + j)
                    return tuple(s[k] - kij * sld(x + j * nk + k)
                                 for k in range(nk))

                s = loop(0, m, acc, tuple(sld(S["RB"] + i * nk + k)
                                         for k in range(nk)))
                for k in range(nk):
                    sst(S["R"] + i * nk + k, s[k])
                return nr + n_rows(s)

            return loop(0, m, row, zero)

        solve(S["RB"], S["X"])
        for _ in range(refine):
            residual(S["X"])
            solve(S["R"], S["DX"])

            def add(r):
                for k in range(nk):
                    e = S["X"] + r * nk + k
                    sst(e, sld(e) + sld(S["DX"] + r * nk + k))

            each(m, add)

        # --- backward-stability gate (ops.ldlt.ldlt_solve_refined with
        # check_residual: ||r|| <= rtol (||K|| ||x|| + ||b||), Frobenius) ---
        nR = residual(S["X"])

        # --- gains out; value recursion Vxx = C + beta'B + omega'cx,
        # Vx = lx + cx'phi + beta'Qu + omega'c + fx'Vx', dL += Qu'alpha +
        # c'psi, all read off X and rhs = -[Qu B; c cx] ---
        def v_row(r, carry):
            V, v, dL, nX, x_fin = carry
            xr = [sld(S["X"] + r * nk + k) for k in range(nk)]
            br = [sld(S["RB"] + r * nk + k) for k in range(nk)]
            for k in range(nk):
                plgpu.store(x_ref.at[pid, t, at(r * nk + k)], xr[k])
            V = [[V[i][j] - xr[1 + i] * br[1 + j] for j in range(nx)]
                 for i in range(nx)]
            v = [v[i] - xr[1 + i] * br[0] for i in range(nx)]
            for k in range(nk):
                x_fin = x_fin & jnp.isfinite(xr[k])
            return V, v, dL - br[0] * xr[0], nX + n_rows(xr), x_fin

        V, v, dL_t, nX, x_fin = loop(
            0, m, v_row, (C, [zero] * nx, zero, zero, jnp.ones_like(mu) > 0))
        Vxx_new = [[0.5 * (V[i][j] + V[j][i]) for j in range(nx)]
                   for i in range(nx)]
        Vx_new = []
        for i in range(nx):
            s = w("lx", i)
            for c in range(nc):
                s = s + w("cx", c, i) * w("phi", c)
            s = s + v[i]
            for k in range(nx):
                s = s + fx[k][i] * Vx[k]
            Vx_new.append(s)
        solve_ok = ((jnp.sqrt(nR) <= rtol * (jnp.sqrt(nK) * jnp.sqrt(nX)
                                             + jnp.sqrt(nB))) & x_fin)
        ok = finite & (n_zero == 0) & (n_pos == nu) & solve_ok
        return Vx_new, Vxx_new, dL_t, ok, n_zero > 0

    def body(i, carry):
        Vx, Vxx, dL, fail, singular = carry
        Vx, Vxx, dL_t, ok, sing = stage(T - 1 - i, Vx, Vxx)
        one, nil = jnp.int32(1), jnp.int32(0)
        first_fail = (fail == 0) & ~ok
        singular = singular | jnp.where(first_fail & sing, one, nil)
        fail = fail | jnp.where(ok, nil, one)
        return Vx, Vxx, dL + dL_t, fail, singular

    izero = jnp.zeros_like(lane)
    _, _, dL, fail, singular = loop(
        0, T, body, (Vx0, Vxx0, jnp.zeros((tile_b,), dt), izero, izero))
    plgpu.store(dl_ref.at[pid, lane], dL)
    plgpu.store(flag_ref.at[pid, at(0)], fail)
    plgpu.store(flag_ref.at[pid, at(1)], singular)


@partial(jax.jit, static_argnames=("nx", "nu", "nc", "refine", "rtol",
                                   "tile_b", "num_warps", "interpret"))
def backward_sweep_pallas(
        fx, fu, lx, lu, lxx, lux, luu, cx, cu, sec,
        c_rel, il, iu, phi, zl, zu, lTx, lTxx, mu, reg, delta_c,
        *, nx, nu, nc, refine, rtol, tile_b=None, num_warps=1,
        interpret=False):
    """Full-batch backward sweep. Per-stage arguments are batch-leading
    `[B, T, ...]` (`sec` may be None: quasi-Newton), per-instance scalars
    mu/reg/delta_c are `[B]`. Returns the gains as `[B, T, ...]` arrays plus
    (dL [B], fail [B] bool, singular [B] bool): one `backward._run_pass`
    attempt, batched. `interpret=True` runs the Pallas interpreter (tests
    on a machine without a GPU).

    `tile_b` instances per program, one warp each: 32 in f32 and 16 in
    f64 measured fastest for concar at b2048 on an H100 (16-128 lanes
    with 1-4 warps tried)."""
    B, T = fx.shape[0], fx.shape[1]
    dtype = fx.dtype
    if tile_b is None:
        tile_b = 32 if dtype == jnp.float32 else 16
    m, nk = nu + nc, nx + 1
    has_sec = sec is not None
    layout, n_entries = _layout(nx, nu, nc, has_sec)
    nb = pl.cdiv(B, tile_b)
    pad = nb * tile_b - B

    def tiles(a):
        """[B, ...] -> [nb, ..., tile_b]; padding lanes repeat the last
        instance, so they compute finite, ignored values."""
        a = jnp.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1), mode="edge")
        a = a.reshape((nb, tile_b) + a.shape[1:])
        return jnp.moveaxis(a, 1, -1)

    parts = [fx, fu, lx, lu, lxx, lux, luu]
    if nc:
        parts += [cx, cu, c_rel, phi]
    if has_sec:
        parts += [sec[:, :, :nx, :nx], sec[:, :, nx:, :nx],
                  sec[:, :, nx:, nx:]]
    parts += [il, iu, zl, zu]
    w = jnp.concatenate([p.reshape(B, T, -1) for p in parts], axis=-1)
    assert w.shape[-1] == n_entries
    w = tiles(w).reshape(nb, T, n_entries * tile_b)
    head = jnp.concatenate([mu[:, None], reg[:, None], delta_c[:, None],
                            lTx, lTxx.reshape(B, -1)], axis=1)
    head = tiles(head).reshape(nb, -1)
    _, n_scratch = _scratch_layout(m, nk)

    # outputs vary over whatever mesh axes the inputs do (under shard_map
    # the sweep is per-shard); shard_map's check_vma reads this
    vma = getattr(jax.typeof(fx), "vma", frozenset())
    out_shape = (
        jax.ShapeDtypeStruct((nb, T, m * nk * tile_b), dtype, vma=vma),
        jax.ShapeDtypeStruct((nb, tile_b), dtype, vma=vma),
        jax.ShapeDtypeStruct((nb, 2 * tile_b), jnp.int32, vma=vma),
        jax.ShapeDtypeStruct((nb, n_scratch * tile_b), dtype, vma=vma),
        jax.ShapeDtypeStruct((nb, m * tile_b), jnp.int32, vma=vma),
    )
    X, dL, flags, _, _ = pl.pallas_call(
        partial(_kernel, T=T, tile_b=tile_b, nx=nx, nu=nu, nc=nc,
                has_sec=has_sec, refine=refine, rtol=rtol, layout=layout),
        out_shape=out_shape,
        grid=(nb,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="backward_sweep",
    )(head, w)

    untile = lambda a: jnp.moveaxis(a, -1, 1).reshape(
        (nb * tile_b,) + a.shape[1:-1])[:B]
    X = untile(X.reshape(nb, T, m * nk, tile_b)).reshape(B, T, m, nk)
    alpha, beta = X[:, :, :nu, 0], X[:, :, :nu, 1:]
    psi, omega = X[:, :, nu:, 0], X[:, :, nu:, 1:]
    sl, su = 1.0 / il, 1.0 / iu
    sig_l, sig_u = zl * sl, zu * su
    mu_t = mu[:, None, None]
    gains = (alpha, beta, psi, omega,
             mu_t * sl - zl - sig_l * alpha, -sig_l[..., None] * beta,
             mu_t * su - zu + sig_u * alpha, sig_u[..., None] * beta)
    flags = untile(flags.reshape(nb, 2, tile_b))
    return gains, untile(dL), flags[:, 0] > 0, flags[:, 1] > 0
