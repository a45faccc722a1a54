// The DOWN and UP z-marching passes over one level of a 3D batch
// (march3d.cuh), one body each, shared by K6 and K7:
//
//   DOWN  e0 = (w0 dinv) r, kept in a ring of three slices, the nu - 1
//         further pre-sweeps, the residual r - A e on the tile and its
//         2x2x2 restriction; writes e and the coarse residual.  K6 runs it
//         at each level of its cycle above the resident bottom and as the
//         banded cycle's T1.  With CG, K7's pass X: DOWN on r_new = r -
//         alpha q, with x += alpha p, r_new written and the partials of
//         sum|r_new|.
//   UP    e + over P e_c on the window, then the nu post-sweeps (ws
//         reversed), the last on the tile; writes the correction.  K6's
//         levels and the banded cycle's T2.  With CG, K7's pass Z: the
//         pin (z = 0 where D <= 0, matrix-free) and the partials of
//         <r_new, z>.
//
// Halos: nu a side, so sweep s of a chain is valid on the window shrunk by
// s cells; each tile recomputes its halo's values in the plain version's
// order, as the neighbouring tile computes them for its own cells, so every
// tile agrees with the plain version bit for bit.  Segments start on even
// slices and have even lengths (march3d.cuh), so a CTA restricts whole
// 2x2x2 blocks.
#pragma once

#include "cgscalars.cuh"
#include "march3d.cuh"

namespace deff {
namespace march {

// The pre-smoothing schedule ws[0..nu-1], by value into the kernels.
struct W3 {
  double w[MAX_NU3];
};

inline W3 make_w3(const double* ws, int nu) {
  W3 w{};
  for (int i = 0; i < nu && i < MAX_NU3; ++i) w.w[i] = ws[i];
  return w;
}

// Three slices k - 1, k, k + 1 of a ring of NS window slices, read as
// v(dz, e).
template <typename T>
struct Tri {
  const T* m;
  const T* c;
  const T* p;
  __device__ __forceinline__ T operator()(int dz, int i) const {
    return dz < 0 ? m[i] : dz > 0 ? p[i] : c[i];
  }
};

template <int N, int NS, typename T>
__device__ __forceinline__ Tri<T> tri(const T* base, int k) {
  return Tri<T>{base + ((k + NS - 1) % NS) * N, base + (k % NS) * N,
                base + ((k + 1) % NS) * N};
}

// One damped-Jacobi sweep of slice k, out = (1 - w) in + (w (rhs +
// nbsum(in))) dinv, on the window shrunk by S; f(e, gi, gj, value).
template <int S, typename T, int H, int NC, bool MF, typename V, typename F>
__device__ __forceinline__ void sweep_slice(const Coefs<T, H, NC, MF>& co,
                                            V in, const T* rhs, int k, T w,
                                            T omw, const Dims3& dm, F f) {
  using G = Geo<T, H>;
  const T* aw = co.AW(k);
  const T* an = co.AN(k);
  const T* au = co.AU(k);
  const T* au1 = co.AU(k + 1);
  const T* di = co.DI(k);
  for_win<G, S>(co.gi0, co.gj0, [&](int e, int gi, int gj) {
    const T nb = nb7<G::WX>(aw, an, au, au1, in, e, k, dm);
    f(e, gi, gj, omw * in(0, e) + (w * (rhs[e] + nb)) * di[e]);
  });
}

// Stage the first commit group (the coefficient rings' prime and the slices
// of steps t0 .. t0 + PD - 1), wait for it, and rebuild slice t0's faces
// (matrix-free).
template <typename CO, typename T, typename I>
__device__ __forceinline__ void prologue(const CO& co, const Vol0<T>& v,
                                         size_t off, int t0, I issue) {
  co.prime(v, off, t0);
  for (int j = 0; j < PD; ++j) issue(t0 + j);
  cp_commit();
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  co.first_faces(v, t0);
  __syncthreads();
}

// The coarse cells of a CTA's footprint that lie past the fine volume (the
// coarse level's even padding) receive 0, as the plain restriction's zero
// padding gives them: the tile's coarse cells, reaching to the coarse
// level's edge on the last tile row, the last tile column and the last
// segment.  The restriction stage writes the others.
template <int TY, typename T>
__device__ __forceinline__ void zero_coarse_pad(T* rcb, const Tile3& tl,
                                                const Dims3& dm,
                                                const Dims3& dc) {
  const bool ly = tl.i0 + TY >= dm.ny, lx = tl.j0 + TX >= dm.nx,
             lz = tl.ze >= dm.nz;
  if (!((ly && 2 * dc.ny > dm.ny) || (lx && 2 * dc.nx > dm.nx) ||
        (lz && 2 * dc.nz > dm.nz)))
    return;
  const int I0 = tl.i0 / 2, J0 = tl.j0 / 2, K0 = tl.zs / 2;
  const int I1 = ly ? dc.ny : min(I0 + TY / 2, dc.ny);
  const int J1 = lx ? dc.nx : min(J0 + TX / 2, dc.nx);
  const int K1 = lz ? dc.nz : min(tl.ze / 2, dc.nz);
  const int ni = I1 - I0, nj = J1 - J0, n = (K1 - K0) * ni * nj;
  for (int c = threadIdx.x; c < n; c += NT) {
    const int K = K0 + c / (ni * nj), rem = c % (ni * nj);
    const int I = I0 + rem / nj, J = J0 + rem % nj;
    if (2 * K >= dm.nz || 2 * I >= dm.ny || 2 * J >= dm.nx)
      rcb[((size_t)K * dc.ny + I) * dc.nx + J] = T(0);
  }
}

// ---- DOWN over the level v into e (ebuf) and the coarse residual rc (the
// coarse shape dc).  The right-hand side is r0; with CG (K7's pass X) it is
// r_old = r0 or r1 by the volume's parity, r_new = r_old - alpha q goes to
// the other one, x += alpha p (p0 or p1) and the CTA's partial of
// sum|r_new| to s.part_b.  The launch gives smem_bytes(CG ? 1 : 3,
// sizeof(T), NU, MF) bytes of dynamic shared memory.
template <typename T, int NU, bool MF, bool CG>
__device__ __forceinline__ void down3_body(
    const Vol0<T>& v, T* __restrict__ x, const T* p0, const T* p1, T* r0,
    T* r1, const T* __restrict__ qbuf, T* __restrict__ ebuf,
    T* __restrict__ rc, const Dims3& dc, const int* flag,
    const CgState<T>& s, const W3& ws, int seglen) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int H = NU, NR = NU + 1 + PD;
  constexpr int NQ = CG ? 1 + PD : 0, NC = coef_slots(CG ? 1 : 3, NU);
  using G = Geo<T, H>;
  if (gated_off(flag)) return;
  const int b = blockIdx.y;
  const Dims3 dm = v.dm;
  const Tile3 tl = tile3<G::TY>(dm, seglen);
  const size_t off = (size_t)b * dm.cells();
  const int par = CG ? s.par[b] : 0;
  const T alpha = CG ? s.alpha[b] : T(0);
  const T* rold = (par ? r1 : r0) + off;
  // CG: x, p and q of the volume, and where r_new goes
  T* xb = CG ? x + off : nullptr;
  const T* pb = CG ? (par ? p0 : p1) + off : nullptr;
  const T* qb = CG ? qbuf + off : nullptr;
  T* rnew = CG ? (par ? r0 : r1) + off : nullptr;
  T* eb = ebuf + off;
  T* rcb = rc + (size_t)b * dc.cells();
  const T w0 = (T)ws.w[0];
  const int gi0 = tl.i0 - H, gj0 = tl.j0 - H;
  T* sp = reinterpret_cast<T*>(smem_raw);
  const Coefs<T, H, NC, MF> co(sp, gi0, gj0, dm);
  T* RR = sp;                          // r, then r_new in place: NR slices
  T* QQ = RR + NR * G::N;              // q (CG): NQ slices
  T* E0 = QQ + NQ * G::N;              // e0 = (w0 dinv) r: 3 slices
  T* EE = E0 + 3 * G::N;               // sweep s (1..nu-1): 3 slices each
  constexpr int TN = G::TY * TX, NT1 = CG ? 1 + PD : 0;
  T* XS = EE + 3 * (NU - 1) * G::N;    // x at the tile (CG): NT1 slices
  T* PS = XS + NT1 * TN;               // p at the tile (CG): NT1 slices
  T* RS = PS + NT1 * TN;               // the tile's residuals of a slice
  const int t0 = tl.zs - H > 0 ? tl.zs - H : 0;
  const int t1 = tl.ze - 1 + H < dm.nz - 1 ? tl.ze - 1 + H : dm.nz - 1;
  auto issue = [&](int k) {
    if (k > t1) return;
    co.win.stage(RR + (k % NR) * G::N, rold, k, dm);
    if constexpr (CG) {
      co.win.stage(QQ + (k % NQ) * G::N, qb, k, dm);
      if (k >= tl.zs && k < tl.ze) {
        stage_block<G::TY, TX>(XS + (k % NT1) * TN, xb, k, tl.i0, tl.j0,
                               dm.ny, dm.nx);
        stage_block<G::TY, TX>(PS + (k % NT1) * TN, pb, k, tl.i0, tl.j0,
                               dm.ny, dm.nx);
      }
    }
    co.issue(v, off, k);
  };
  // a cell of the tile on the plane (what this CTA stores)
  auto tile_cell = [&](int gi, int gj) {
    return gi >= tl.i0 && gi < tl.i0 + G::TY && gj >= tl.j0 &&
           gj < tl.j0 + TX && gi < dm.ny && gj < dm.nx;
  };
  prologue(co, v, off, t0, issue);
  double acc = 0.0;
  T zsum[2][2] = {{T(0), T(0)}, {T(0), T(0)}};
  for (int t = t0; t <= tl.ze - 1 + H; ++t) {
    issue(t + PD);
    cp_commit();
    cp_wait_step();
    if (t <= t1) {
      co.rebuild(v, t);
      T* R = RR + (t % NR) * G::N;
      const T* Q = QQ + (t % (CG ? NQ : 1)) * G::N;
      T* e0 = E0 + (t % 3) * G::N;
      const T* xs = XS + (t % (CG ? NT1 : 1)) * TN;
      const T* ps = PS + (t % (CG ? NT1 : 1)) * TN;
      const T* di = co.DI(t);
      const bool own = t >= tl.zs && t < tl.ze;
      const size_t ks = (size_t)t * dm.plane();
      for_win<G, 0>(gi0, gj0, [&](int e, int gi, int gj) {
        T rv = R[e];
        if constexpr (CG) {
          rv = rv - alpha * Q[e];
          R[e] = rv;
        }
        const T ev = (w0 * di[e]) * rv;
        e0[e] = ev;
        if (own && tile_cell(gi, gj)) {
          const size_t g = ks + (size_t)gi * dm.nx + gj;
          if constexpr (CG) {
            const int ti = (gi - tl.i0) * TX + (gj - tl.j0);
            xb[g] = xs[ti] + alpha * ps[ti];
            rnew[g] = rv;
            acc += (double)(rv < T(0) ? -rv : rv);
          }
          if (NU == 1) eb[g] = ev;
        }
      });
      __syncthreads();
    }
    if constexpr (NU >= 2) {             // sweep 1 on slice t - 1
      const int k = t - 1;
      if (k >= 0 && k >= tl.zs - (NU - 1) && k < tl.ze + (NU - 1) &&
          k < dm.nz) {
        T* out = EE + (k % 3) * G::N;
        const bool own = k >= tl.zs && k < tl.ze;
        const size_t ks = (size_t)k * dm.plane();
        sweep_slice<1>(co, tri<G::N, 3>(E0, k), RR + (k % NR) * G::N, k,
                       (T)ws.w[1], (T)(1.0 - ws.w[1]), dm,
                       [&](int e, int gi, int gj, T val) {
                         out[e] = val;
                         if (NU == 2 && own && tile_cell(gi, gj))
                           eb[ks + (size_t)gi * dm.nx + gj] = val;
                       });
      }
      __syncthreads();
    }
    if constexpr (NU >= 3) {             // sweep 2 on slice t - 2
      const int k = t - 2;
      if (k >= 0 && k >= tl.zs - (NU - 2) && k < tl.ze + (NU - 2) &&
          k < dm.nz) {
        T* out = EE + (3 + k % 3) * G::N;
        const bool own = k >= tl.zs && k < tl.ze;
        const size_t ks = (size_t)k * dm.plane();
        sweep_slice<2>(co, tri<G::N, 3>(EE, k), RR + (k % NR) * G::N, k,
                       (T)ws.w[2], (T)(1.0 - ws.w[2]), dm,
                       [&](int e, int gi, int gj, T val) {
                         out[e] = val;
                         if (own && tile_cell(gi, gj))
                           eb[ks + (size_t)gi * dm.nx + gj] = val;
                       });
      }
      __syncthreads();
    }
    // the residual r - A e on the tile of slice t - nu, then summed over z
    // pairs in registers and restricted at each odd slice (one thread a
    // coarse cell)
    const int k = t - NU;
    if (k >= tl.zs && k < tl.ze) {
      const T* R = RR + (k % NR) * G::N;
      const T* di = co.DI(k);
      const T* aw = co.AW(k);
      const T* an = co.AN(k);
      const T* au = co.AU(k);
      const T* au1 = co.AU(k + 1);
      const Tri<T> ev = NU == 1 ? tri<G::N, 3>(E0, k)
                                : tri<G::N, 3>(EE + 3 * (NU - 2) * G::N, k);
      for_win<G, H>(gi0, gj0, [&](int e, int gi, int gj) {
        RS[(gi - tl.i0) * TX + (gj - tl.j0)] =
            R[e] - (diag_of(di[e]) * ev(0, e) -
                    nb7<G::WX>(aw, an, au, au1, ev, e, k, dm));
      });
      __syncthreads();
      constexpr int CX = TX / 2, CN = (G::TY / 2) * CX;
      const int I = tl.i0 / 2 + threadIdx.x / CX;
      const int J = tl.j0 / 2 + threadIdx.x % CX;
      if (threadIdx.x < CN && 2 * I < dm.ny && 2 * J < dm.nx) {
        const int c0 = (2 * I - tl.i0) * TX + (2 * J - tl.j0);
        for (int a = 0; a < 2; ++a)
          for (int cc = 0; cc < 2; ++cc) {
            const T rv = RS[c0 + a * TX + cc];
            zsum[a][cc] = (k & 1) ? zsum[a][cc] + rv : rv;
          }
        if (k & 1)
          rcb[((size_t)(k >> 1) * dc.ny + I) * dc.nx + J] =
              (zsum[0][0] + zsum[1][0]) + (zsum[0][1] + zsum[1][1]);
      }
    }
    __syncthreads();
  }
  zero_coarse_pad<G::TY>(rcb, tl, dm, dc);
  if constexpr (CG) {
    __shared__ double sh[THREADS];
    const double sum = block_sum_fixed(acc, sh);
    if (threadIdx.x == 0) s.part_b[(size_t)b * s.ntiles + blockIdx.x] = sum;
  }
}

// ---- UP over the level v: src = e + over e_c[k/2, i/2, j/2] on the
// window, then the nu post-sweeps (ws reversed) give the correction zbuf;
// the right-hand side is r0.  With CG (K7's pass Z) it is r_new = r0 or r1
// by the volume's parity, z is pinned to 0 where D <= 0 (MF) and the CTA's
// partial of <r_new, z> goes to s.part_c.  The launch gives
// smem_bytes(CG ? 2 : 4, sizeof(T), NU, MF) bytes of dynamic shared memory.
template <typename T, int NU, bool MF, bool CG>
__device__ __forceinline__ void up3_body(
    const Vol0<T>& v, const T* r0, const T* r1, const T* __restrict__ ebuf,
    const T* __restrict__ ec, const Dims3& dc, T over, T* __restrict__ zbuf,
    const int* flag, const CgState<T>& s, const W3& ws, int seglen) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int H = NU, NS = 3 + PD, NR = NU + 1 + PD;
  constexpr int NC = coef_slots(CG ? 2 : 4, NU);
  using G = Geo<T, H>;
  if (gated_off(flag)) return;
  const int b = blockIdx.y;
  const Dims3 dm = v.dm;
  const Tile3 tl = tile3<G::TY>(dm, seglen);
  const size_t off = (size_t)b * dm.cells();
  const T* rnew = (CG ? (s.par[b] ? r0 : r1) : r0) + off;
  const T* eb = ebuf + off;
  const T* ecb = ec + (size_t)b * dc.cells();
  T* zb = zbuf + off;
  const int gi0 = tl.i0 - H, gj0 = tl.j0 - H;
  T* sp = reinterpret_cast<T*>(smem_raw);
  const Coefs<T, H, NC, MF> co(sp, gi0, gj0, dm);
  T* SS = sp;                          // e, then e + over P e_c: NS slices
  T* RR = SS + NS * G::N;              // r: NR slices
  T* EE = RR + NR * G::N;              // sweep s (1..nu-1): 3 slices each
  // e_c under the window of each staged slice (the coarse slice k / 2),
  // and D at the tile's cells for the pin (matrix-free)
  constexpr int CR = G::TY / 2 + H + 1, CC = TX / 2 + H + 1;
  constexpr int NE = 1 + PD, TN = G::TY * TX;
  T* EC = EE + 3 * (NU - 1) * G::N;
  T* PN = EC + NE * CR * CC;           // NU + 1 tile slices
  const int ci0 = gi0 >> 1, cj0 = gj0 >> 1;   // floor: gi0 may be < 0
  const int t0 = tl.zs - H > 0 ? tl.zs - H : 0;
  const int t1 = tl.ze - 1 + H < dm.nz - 1 ? tl.ze - 1 + H : dm.nz - 1;
  auto issue = [&](int k) {
    if (k > t1) return;
    co.win.stage(SS + (k % NS) * G::N, eb, k, dm);
    co.win.stage(RR + (k % NR) * G::N, rnew, k, dm);
    stage_block<CR, CC>(EC + (k % NE) * CR * CC, ecb, k >> 1, ci0, cj0,
                        dc.ny, dc.nx);
    co.issue(v, off, k);
  };
  prologue(co, v, off, t0, issue);
  double acc = 0.0;
  for (int t = t0; t <= tl.ze - 1 + H; ++t) {
    issue(t + PD);
    cp_commit();
    cp_wait_step();
    if (t <= t1) {
      co.rebuild(v, t);
      T* S = SS + (t % NS) * G::N;
      const T* cs = EC + (t % NE) * CR * CC;
      T* pn = PN + (t % (NU + 1)) * TN;
      const T* dk = MF ? co.Dk(t) : nullptr;
      for_win<G, 0>(gi0, gj0, [&](int e, int gi, int gj) {
        S[e] = S[e] + over * cs[((gi >> 1) - ci0) * CC + ((gj >> 1) - cj0)];
        if (MF && gi >= tl.i0 && gi < tl.i0 + G::TY && gj >= tl.j0 &&
            gj < tl.j0 + TX)
          pn[(gi - tl.i0) * TX + (gj - tl.j0)] =
              dk[(gi - gi0 + 1) * G::DX + (gj - gj0 + 1)];
      });
      __syncthreads();
    }
    // sweeps 1..nu-1 (weights ws[nu-1] .. ws[1]) into their rings
    if constexpr (NU >= 2) {
      const int k = t - 1;
      if (k >= 0 && k >= tl.zs - (NU - 1) && k < tl.ze + (NU - 1) &&
          k < dm.nz) {
        T* out = EE + (k % 3) * G::N;
        sweep_slice<1>(co, tri<G::N, NS>(SS, k), RR + (k % NR) * G::N, k,
                       (T)ws.w[NU - 1], (T)(1.0 - ws.w[NU - 1]), dm,
                       [&](int e, int, int, T val) { out[e] = val; });
      }
      __syncthreads();
    }
    if constexpr (NU >= 3) {
      const int k = t - 2;
      if (k >= 0 && k >= tl.zs - (NU - 2) && k < tl.ze + (NU - 2) &&
          k < dm.nz) {
        T* out = EE + (3 + k % 3) * G::N;
        sweep_slice<2>(co, tri<G::N, 3>(EE, k), RR + (k % NR) * G::N, k,
                       (T)ws.w[NU - 2], (T)(1.0 - ws.w[NU - 2]), dm,
                       [&](int e, int, int, T val) { out[e] = val; });
      }
      __syncthreads();
    }
    // the last sweep (ws[0]) on the tile of slice t - nu gives z
    const int k = t - NU;
    if (k >= tl.zs && k < tl.ze) {
      const T* R = RR + (k % NR) * G::N;
      const T* pn = PN + (k % (NU + 1)) * TN;
      const size_t ks = (size_t)k * dm.plane();
      auto last = [&](auto in) {
        sweep_slice<NU>(co, in, R, k, (T)ws.w[0], (T)(1.0 - ws.w[0]), dm,
                        [&](int e, int gi, int gj, T val) {
                          if (!in_plane(gi, gj, dm)) return;
                          const size_t g = ks + (size_t)gi * dm.nx + gj;
                          if (MF && !(pn[(gi - tl.i0) * TX + (gj - tl.j0)] >
                                      T(0)))
                            val = T(0);
                          zb[g] = val;
                          if constexpr (CG) {
                            const T prod = R[e] * val;
                            acc += (double)prod;
                          }
                        });
      };
      if constexpr (NU == 1)
        last(tri<G::N, NS>(SS, k));
      else
        last(tri<G::N, 3>(EE + 3 * (NU - 2) * G::N, k));
    }
    __syncthreads();
  }
  if constexpr (CG) {
    __shared__ double sh[THREADS];
    const double sum = block_sum_fixed(acc, sh);
    if (threadIdx.x == 0) s.part_c[(size_t)b * s.ntiles + blockIdx.x] = sum;
  }
}

}  // namespace march
}  // namespace deff
