"""Copies of the fp32 flash joint's kernel source
(conformer_nemo_tpu_torch/ops/csrc/rnnt_joint_f32.cu), each with one part
changed or removed by named string replacements, built side by side with
nvcc and timed in turns with the source itself through the package's
wrappers, at the transducer step's shapes: B 16, T 391, U+1 129, H 640, V
296, the frame and label lengths the loader gives chip_smoke.py's
transducer manifest (173,233 lattice cells), drop_t 26. On an H100:

    python3 joint_variants.py [NAME ...]   # default: every variant

It prints what nvcc's ptxas reports for each copy, then a JSON line per
variant and turn (three turns, the order reversed in the second): the
forward's ms (CUDA events over 10 calls), the cells and sums kernels' device
ms in a whole backward (torch.profiler), and, in the first turn, each
output's largest error against the plain fp32 version relative to its
largest entry; last, a summary line with the card's name and power limit.
The copies are built under the package's git-ignored build directory.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from conformer_nemo_tpu_torch.ops import build  # noqa: E402
from conformer_nemo_tpu_torch.ops import rnnt_joint as jt  # noqa: E402
from conformer_nemo_tpu_torch.ops import rnnt_lattice as lat  # noqa: E402
from conformer_nemo_tpu_torch.ops.rnnt_loss import posteriors  # noqa: E402

SOURCE = "rnnt_joint_f32.cu"
T_LENS = [373, 273, 326, 389, 341, 319, 373, 325, 352, 265, 275, 268, 337, 333, 371, 305]
U_LENS = [41, 32, 35, 34, 38, 35, 32, 29, 38, 22, 22, 25, 32, 30, 29, 34]

# tc_dh replaces the source's cells_dh (_FMA_DH, which must match it as it
# stands) by dh on the tensor cores in 3xTF32 (_TC_DH): mma.sync m16n8k8
# with the hidden units the product's rows and the warp's 8 cells its
# columns, W_lab^T split into hi and lo rows by the wrapper (8 label columns
# a slice), each k-step's three products summed apart; the stage's rows 8
# floats apart beyond CW, so that the fragments' rows fall in distinct banks
_FMA_DH = """template <int M2>
__device__ inline void cells_dh(const Joint<F32>& J, const CellsArgs& A, Ring<CellsPlan>& R,
                                int& i, const TileMeta& M, const float* DlT, int warp, int lane,
                                int h0, int pw, bool first, bool last, int rows, size_t row0) {
  float acc[WR][2 * M2];
#pragma unroll
  for (int r = 0; r < WR; ++r)
#pragma unroll
    for (int j = 0; j < 2 * M2; ++j) acc[r][j] = 0.f;
  for (int s = 0; s < pw / KS; ++s, ++i) {
    fma_wide<M2, 4>(acc, DlT + s * KS * WR, R.take(i), lane);
    R.release(i);
  }
  const int H = J.H;
  const float keep = J.drop_t > 0 ? J.inv_keep : 1.f;
  // acc's entries in groups of 4 hidden units (the last of 2 for M2 odd),
  // each group inside H or past it (H and the groups' starts multiples of 4)
#pragma unroll
  for (int j0 = 0; j0 < 2 * M2; j0 += 4) {
    const int n = min(4, 2 * M2 - j0), h = h0 + col_of<M2>(j0, lane);
    if (h >= H) continue;
    float wb[4];
#pragma unroll
    for (int e = 0; e < n; ++e) wb[e] = __ldg(A.w_blank + h + e);
#pragma unroll
    for (int r = 0; r < WR; ++r) {
      const int row = WR * warp + r;
      if (row >= rows) continue;
      float sum[4];
#pragma unroll
      for (int e = 0; e < n; ++e) sum[e] = acc[r][j0 + e];
      if (A.dh_part != nullptr) {
        float* part = A.dh_part + (row0 + row) * H + h;
        if (!first)
#pragma unroll
          for (int e = 0; e < n; ++e) sum[e] = part[e] + sum[e];
        if (!last) {
#pragma unroll
          for (int e = 0; e < n; ++e) part[e] = sum[e];
          continue;
        }
      }
      float* gx = A.dx_out + (row0 + row) * H + h;
      const float db = M.dblank[row];
#pragma unroll
      for (int e = 0; e < n; ++e) gx[e] = (sum[e] + db * wb[e]) * keep * gx[e];
    }
  }
}"""

_TC_DH = """template <int M2>
__device__ inline void cells_dh(const Joint<F32>& J, const CellsArgs& A, Ring<CellsPlan>& R,
                                int& i, const TileMeta& M, const float* DlT, int warp, int lane,
                                int h0, int pw, bool first, bool last, int rows, size_t row0) {
  constexpr int NM = 4 * M2;
  const int H = J.H, nm = min(NM, (H - h0) / 16), g = lane >> 2, t = lane & 3;
  float acc[NM][4];
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[m][q] = 0.f;
  for (int s = 0; s < pw / 8; ++s, ++i) {
    const float* st = R.take(i);
    uint32_t b0h, b0l, b1h, b1l;
    split_tf32(DlT[(8 * s + t) * WR + g], b0h, b0l);
    split_tf32(DlT[(8 * s + t + 4) * WR + g], b1h, b1l);
    // four 16-unit tiles at a time: their three products interleave (the
    // tiles past nm take stale columns of the stage and are not written)
#pragma unroll
    for (int m0 = 0; m0 < NM; m0 += 4) {
      uint32_t ah[4][4], al[4][4];
      float d[4][4];
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) {
        const float* hi = st + t * STR + 16 * (m0 + mm) + g;
        const float* lo = hi + 8 * STR;
        ah[mm][0] = __float_as_uint(hi[0]);
        ah[mm][1] = __float_as_uint(hi[8]);
        ah[mm][2] = __float_as_uint(hi[4 * STR]);
        ah[mm][3] = __float_as_uint(hi[4 * STR + 8]);
        al[mm][0] = __float_as_uint(lo[0]);
        al[mm][1] = __float_as_uint(lo[8]);
        al[mm][2] = __float_as_uint(lo[4 * STR]);
        al[mm][3] = __float_as_uint(lo[4 * STR + 8]);
      }
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) mma1688_zero(d[mm], al[mm], b0h, b1h);
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) mma1688(d[mm], ah[mm], b0l, b1l);
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) mma1688(d[mm], ah[mm], b0h, b1h);
#pragma unroll
      for (int mm = 0; mm < 4; ++mm)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m0 + mm][q] += d[mm][q];
    }
    R.release(i);
  }
  const float keep = J.drop_t > 0 ? J.inv_keep : 1.f;
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    if (m >= nm) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // acc[m][q]: hidden unit 16 m + g (+ 8 for q 2, 3) of cell 2 t (+ 1 for q odd)
      const int row = WR * warp + 2 * t + (q & 1), h = h0 + 16 * m + g + 8 * (q >> 1);
      if (row >= rows) continue;
      float sum = acc[m][q];
      if (A.dh_part != nullptr) {
        float* part = A.dh_part + (row0 + row) * H + h;
        if (!first) sum = *part + sum;
        if (!last) {
          *part = sum;
          continue;
        }
      }
      float* gx = A.dx_out + (row0 + row) * H + h;
      *gx = (sum + M.dblank[row] * __ldg(A.w_blank + h)) * keep * *gx;
    }
  }
}"""

VARIANTS = {
    "nobuild": [  # h without the activation and the dropout hash
        ("for (int i = 0; i < 4; ++i) hidden_unit(J, x[i], B.hrow, k + i, h[i], g[i]);",
         "for (int i = 0; i < 4; ++i) { h[i] = x[i]; g[i] = 1.f; }")],
    "halffma": [  # half the FMAs of both kernels' pieces, every loaded float used
        ("    for (int r = 0; r < WR; ++r)\n#pragma unroll\n"
         "      for (int j = 0; j < 2 * M2; ++j) acc[r][j] = fmaf(a[r], b[j], acc[r][j]);",
         "    for (int r = 0; r < WR; r += 2)\n#pragma unroll\n"
         "      for (int j = 0; j < 2 * M2; ++j) acc[r][j] = fmaf(a[r], b[j], acc[r][j]);")],
    "nowait": [  # the ring's first stages only: no refills, no waits past them
        ("    const int j = i - LAG;\n"
         "    if (j >= 0 && j + STAGES < n && warp == i % nw) {\n"
         "      if (lane == 0) mbar_wait(&empty[j % STAGES], (j / STAGES) & 1);\n"
         "      __syncwarp();\n"
         "      issue(j + STAGES);\n"
         "    }\n"
         "    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);",
         "    if (i < STAGES) mbar_wait(&full[i % STAGES], 0);"),
        ("if (lane == 0) mbar_arrive(&empty[i % STAGES]);", "(void)i;")],
    "noscratch": [  # no h and act' writes to the window's scratch, no act' read
        ("build(J, B, Hs, s * KS + 4 * q, lane, scratch);",
         "build(J, B, Hs, s * KS + 4 * q, lane, false);"),
        ("gx[e] = (sum[e] + db * wb[e]) * keep * gx[e];", "gx[e] = (sum[e] + db * wb[e]) * keep;")],
    "nodhfma": [  # no dh FMAs (the ring's slices still taken)
        ("fma_wide<M2, 4>(acc, DlT + s * KS * WR, R.take(i), lane);",
         "if (R.take(i) == nullptr) acc[0][0] = 1.f;")],
    "fwd8warps": [("constexpr int FWARPS = 12;", "constexpr int FWARPS = 8; ")],
    "fwd_unroll8": [  # the forward's k loop unrolled by 8, not 16
        ("sweep<M2, KS>(J, R, i, acc, B, Hw, lane, false, nullptr, unused);",
         "sweep<M2, 8>(J, R, i, acc, B, Hw, lane, false, nullptr, unused);")],
    "tc_dh": [
        ("constexpr int CW = 320;", "constexpr int CW = 320;\nconstexpr int STR = CW + 8;"),
        ("sizeof(float) * STAGES * KS * CW;", "sizeof(float) * STAGES * KS * STR;"),
        ("stage + (size_t)(g % STAGES) * KS * CW + lane * CW,",
         "stage + (size_t)(g % STAGES) * KS * STR + lane * STR,"),
        ("return stage + (size_t)(i % STAGES) * KS * CW;", "return stage + (size_t)(i % STAGES) * KS * STR;"),
        ("(B + k * CW + 128 * q + 4 * lane)", "(B + k * STR + 128 * q + 4 * lane)"),
        ("(B + k * CW + 128 * Q + 2 * lane)", "(B + k * STR + 128 * Q + 2 * lane)"),
        ("nd = pw / KS;", "nd = pw / 8;"),
        ("wt + (size_t)(p0 + s * KS) * H + h0", "wt + (size_t)(2 * p0 + KS * s) * H + h0"),
        ("nh * VLp / KS;", "nh * VLp / 8;"),
        (_FMA_DH, _TC_DH)],
}


def _tf32(x):
    """fp32 x rounded to tf32 as cvt.rna.tf32.f32 rounds."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split_transposed(w_pad):
    """tc_dh's dh operand: W_lab^T [VLp, H], per 8 label columns their rows'
    hi = tf32(w), then lo = tf32(w - hi), as [2 VLp, H]."""
    wt = w_pad.t().contiguous()
    hi = _tf32(wt)
    lo = _tf32(wt - hi)
    h = wt.shape[1]
    return torch.stack((hi.view(-1, 8, h), lo.view(-1, 8, h)), dim=1).view(-1, h)


def variant_source(name: str, src: str) -> str:
    """`src` with variant `name`'s replacements (each must match once)."""
    for old, new in VARIANTS.get(name, []):
        if src.count(old) != 1:
            raise ValueError(f"{name}: {old[:60]!r} matches {src.count(old)} times")
        src = src.replace(old, new)
    return src


def build_variants(names, out_dir):
    """Each variant (and "base", the source itself) into out_dir/NAME/lib.so,
    all nvcc processes at once -> ({name: CDLL}, {name: ptxas lines})."""
    src = open(os.path.join(build.CSRC_DIR, SOURCE)).read()
    procs = {}
    for name in names:
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        for f in os.listdir(build.CSRC_DIR):
            if f.endswith(".cuh"):
                shutil.copy(os.path.join(build.CSRC_DIR, f), d)
        with open(os.path.join(d, SOURCE), "w") as f:
            f.write(variant_source(name, src))
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler",
             "-fPIC", "-Xptxas", "-v", "-o", os.path.join(d, "lib.so"), os.path.join(d, SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out[-3000:]}")
        ptxas[name] = [l.strip() for l in out.splitlines() if "registers" in l or "spill" in l]
        libs[name] = ctypes.CDLL(os.path.join(out_dir, name, "lib.so"))
    return libs, ptxas


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("joint_variants.py times CUDA kernels: no card here", file=sys.stderr)
        return 1
    names = ["base"] + [n for n in (argv or list(VARIANTS)) if n != "base"]
    unknown = [n for n in names[1:] if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {sorted(VARIANTS)}")
    libs, ptxas = build_variants(names, os.path.join(build.BUILD_DIR, "variants"))
    for n in names:
        print(json.dumps({"variant": n, "ptxas": ptxas[n]}), flush=True)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    b, t, u, h, v = 16, 391, 128, 640, 296
    gen = torch.Generator(device=dev).manual_seed(1234)
    rn = lambda *s, scale: torch.randn(*s, generator=gen, device=dev) * scale
    e, p = rn(b, t, h, scale=0.5), rn(b, u + 1, h, scale=0.5)
    w, bias = rn(h, v, scale=h ** -0.5), rn(v, scale=0.1)
    targets = torch.randint(0, v - 1, (b, u), generator=gen, device=dev).to(torch.int32)
    tl = torch.tensor(T_LENS, dtype=torch.int32, device=dev)
    ul = torch.tensor(U_LENS, dtype=torch.int32, device=dev)
    seed = jt.joint_seed(20250, 0, t, u + 1, h, 16)
    kw = dict(t_lens=tl, u_lens=ul, blank_id=v - 1, activation="relu", drop_t=26, bt=16)
    plain_wt = jt._transposed

    def use(name):
        build._LIBS[SOURCE] = libs[name]
        jt._transposed = _split_transposed if name == "tc_dh" else plain_wt

    use("base")
    blank_lp, label_lp, lse = jt.joint_flash_fwd(e, p, w, bias, targets, seed, **kw)
    ll = label_lp.clone()
    ll[:, :, -1] = -1e30
    alpha, beta = lat.rnnt_alphas(blank_lp, ll, tl, ul), lat.rnnt_betas(blank_lp, ll, tl, ul)
    gb, gy = posteriors(alpha, beta, blank_lp, ll, tl, ul)
    g = torch.rand(b, generator=gen, device=dev) + 0.5
    args = (e, p, w, bias, targets, lse, (gb + gy).contiguous(), gb.contiguous(),
            gy.contiguous(), g, seed)
    ref_f = jt.joint_flash_fwd_reference(e, p, w, bias, targets, seed, **kw)
    ref_b = jt.joint_flash_bwd_reference(*args, **kw)
    inside = lat.valid_cells(blank_lp.shape, tl, ul)
    rel = lambda a, r: ((a - r).abs().max() / r.abs().max().clamp_min(1e-30)).item()
    res = {n: {"fwd": [], "cells": [], "sums": []} for n in names}
    for turn, seq in enumerate((names, names[::-1], names)):
        for n in seq:
            use(n)
            f = cs.time_ms(lambda: jt.joint_flash_fwd(e, p, w, bias, targets, seed, **kw), 10)
            k = cs.kernel_device_ms(lambda: jt.joint_flash_bwd(*args, **kw),
                                    {"cells": "joint_bwd_cells", "sums": "joint_bwd_sums"},
                                    iters=3)
            line = {"turn": turn, "variant": n, "fwd_ms": f, "cells_ms": k["cells"],
                    "sums_ms": k["sums"]}
            if turn == 0:
                of = jt.joint_flash_fwd(e, p, w, bias, targets, seed, **kw)
                ob = jt.joint_flash_bwd(*args, **kw)
                line["fwd_rel_err"] = max(rel(x[inside], r[inside]) for x, r in zip(of, ref_f))
                line["bwd_rel_err"] = [rel(x, r) for x, r in zip(ob, ref_b)]
            for key in ("fwd", "cells", "sums"):
                res[n][key].append(line[key + "_ms"])
            print(json.dumps(line), flush=True)
    jt._transposed = plain_wt
    print(json.dumps({"summary": res, "gpu": cs.gpu_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
