// Randomized differential-oracle sweep generator: runs the REFERENCE
// engine (compiled with the single-rank MPI stub, -O2) over a matrix of
// configurations spanning the .edm config space — well/global tempering
// (edm_bias.cpp:422-426,547-549), targeting (:545-546), hill-density
// acceptance modes (:543,551-555), bias_per_step capping + deferral
// (:432-439,465-523), periodic remap vs non-periodic McGDP boundaries
// (gaussian_grid.h:378-435,504-541), in 1-D and 2-D — and dumps exact
// inputs (centers, uniforms) + outputs (per-round cum_bias, grid probes)
// as committed fixtures for tests/test_oracle_sweep.py to replay.
//
// Build (see tests/oracles/README.md):
//   g++ -O2 -std=c++11 -DEDM_SERIAL -I tests/oracles/mpi_stub \
//       -I /root/reference/lib tests/oracles/oracle_sweep.cpp \
//       /root/reference/lib/{grid,gaussian_grid,edm_bias,edm}.cpp \
//       -o /tmp/refbuild/oracle_sweep
//   /tmp/refbuild/oracle_sweep tests/oracles/sweep
#include "edm_bias.h"
#include "grid.h"
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
using namespace EDM;

struct Cfg {
  const char* name;
  int dim;
  double T, kB;
  // .edm scalars; bias_per_step <= 0 means "omit key" (defaults to
  // prefactor, edm_bias.cpp:1020-1021); hill_density 0 means omit
  // (defaults to -1 = accept-all, edm_bias.cpp:40)
  int tempering;
  double bias_factor;      // used when tempering
  double global_tempering; // 0 = omit key; <0 = well-tempered mode
  double prefactor, bias_per_step, hill_density;
  double sigma[2], spacing[2], lo[2], hi[2];
  int periodic[2];
  int target_kind; // 0 none, 1 sine ramp, 2 2-D sine product
  // hill sampling range (may exceed the box: periodic remap /
  // non-periodic reject paths)
  double slo[2], shi[2];
  int rounds, hills, seed;
  // seq = 1: one pre(est)/add_hill/post cycle PER HILL (the reference
  // Python binding's add_hill pattern, python/edm/edm/__init__.py:4-8).
  // Required for exact pins when well-tempering is active: within a
  // multi-hill round the reference tempers each hill against the live
  // grid including same-round deposits, which the JAX engine relaxes to
  // the round-start grid (README "Parity with the reference") — at
  // round size 1 the two are identical.  est is the est_hill_count
  // passed to pre_add_hill either way (the reference hosts pass the
  // previous step's pair/atom count, not the batch size).
  int seq, est;
};

static double urand() { return rand() / (double)RAND_MAX; }

static std::string read_file(const std::string& p) {
  FILE* f = fopen(p.c_str(), "r");
  if (!f) { fprintf(stderr, "missing %s\n", p.c_str()); exit(1); }
  std::string s;
  char buf[4096];
  size_t n;
  while ((n = fread(buf, 1, sizeof(buf), f)) > 0) s.append(buf, n);
  fclose(f);
  return s;
}

static std::string make_target(const Cfg& c, const std::string& dir) {
  std::string path = dir + "/tgt_" + c.name + ".grid";
  if (c.target_kind == 1) {
    // smooth 1-D -lnP-style profile over the box
    double w = c.hi[0] - c.lo[0];
    DimmedGrid<1> t(c.lo, c.hi, c.spacing, c.periodic, 0, 0);
    for (size_t i = 0; i < t.grid_size_; i++) {
      double x = c.lo[0] + i * t.dx_[0];
      t.grid_[i] = 1.3 + 0.9 * sin(2 * M_PI * (x - c.lo[0]) / w) +
                   0.25 * (x - c.lo[0]);
    }
    t.write(path);
  } else {
    DimmedGrid<2> t(c.lo, c.hi, c.spacing, c.periodic, 0, 0);
    double wx = c.hi[0] - c.lo[0], wy = c.hi[1] - c.lo[1];
    size_t idx = 0;
    // column-major: dim 0 fastest (grid.h:315-338)
    for (int j = 0; j < t.grid_number_[1]; j++)
      for (int i = 0; i < t.grid_number_[0]; i++, idx++) {
        double x = c.lo[0] + i * t.dx_[0], y = c.lo[1] + j * t.dx_[1];
        t.grid_[idx] = 1.1 + 0.7 * sin(2 * M_PI * (x - c.lo[0]) / wx) *
                                 cos(2 * M_PI * (y - c.lo[1]) / wy);
      }
    t.write(path);
  }
  return path;
}

int main(int argc, char** argv) {
  if (argc < 2) { fprintf(stderr, "usage: oracle_sweep <outdir>\n"); return 1; }
  std::string outdir = argv[1];
  std::string tmpdir = "/tmp/refbuild";

  std::vector<Cfg> cfgs;
  // 1. 1-D well-tempered (tempering 1, global_tempering -1), periodic box,
  //    accept-all density, no capping pressure.  seq: exact sequential
  //    tempering (1000 one-hill cycles)
  { Cfg c = {"wt1d", 1, 1.19, 1.0, /*temper*/1, 6.0, -1.0, 1.7, 400.0, 0.0,
             {0.13, 0}, {0.0203, 0}, {0.0, 0}, {3.1, 0}, {1, 0},
             0, {-0.4, 0}, {3.5, 0}, 5, 200, 101, 1, 200}; cfgs.push_back(c); }
  // 2. 1-D global tempering (threshold crossed mid-run shrinks prefactor);
  //    heights are grid-independent within a round -> batch is exact
  { Cfg c = {"gt1d", 1, 0.83, 1.0, 1, 4.0, 0.35, 2.3, 600.0, 0.0,
             {0.17, 0}, {0.0311, 0}, {0.0, 0}, {4.2, 0}, {1, 0},
             0, {0.0, 0}, {4.2, 0}, 6, 150, 202, 0, 150}; cfgs.push_back(c); }
  // 3. 1-D targeted + heavy capping on a non-periodic (McGDP) box:
  //    cap crossing, partial undo, deferral + drain + skip rounds
  //    (static target heights -> batch exact incl. the cap prefix)
  { Cfg c = {"captgt1d", 1, 1.0, 1.0, 0, 0.0, 0.0, 9.0, 0.9, 250.0,
             {0.11, 0}, {0.0197, 0}, {0.0, 0}, {3.0, 0}, {0, 0},
             1, {0.05, 0}, {2.95, 0}, 6, 250, 303, 0, 500}; cfgs.push_back(c); }
  // 4. 1-D non-periodic boundary stress: centers sampled beyond the box
  //    (rejected) and hugging the boundary (BC correction + duplication)
  { Cfg c = {"mcgdp1d", 1, 1.0, 1.0, 0, 0.0, 0.0, 0.8, 500.0, 0.0,
             {0.19, 0}, {0.0233, 0}, {-1.0, 0}, {2.0, 0}, {0, 0},
             0, {-1.5, 0}, {2.5, 0}, 4, 180, 404, 0, 180}; cfgs.push_back(c); }
  // 5. 2-D periodic well-tempered (seq: exact sequential tempering)
  { Cfg c = {"wt2d", 2, 1.31, 1.0, 1, 5.0, -1.0, 1.1, 300.0, 0.0,
             {0.21, 0.27}, {0.061, 0.073}, {0.0, -1.0}, {2.9, 1.8}, {1, 1},
             0, {-0.3, -1.2}, {3.2, 2.0}, 4, 90, 505, 1, 120}; cfgs.push_back(c); }
  // 6. 2-D mixed periodicity (x periodic, y non-periodic McGDP)
  { Cfg c = {"mix2d", 2, 1.0, 1.0, 0, 0.0, 0.0, 1.4, 200.0, 60.0,
             {0.23, 0.19}, {0.067, 0.059}, {0.0, 0.0}, {2.7, 2.3}, {1, 0},
             0, {-0.2, 0.05}, {2.9, 2.25}, 5, 160, 606, 0, 160}; cfgs.push_back(c); }
  // 7. 2-D periodic targeted (sine-product target) with stochastic density
  { Cfg c = {"tgt2d", 2, 1.07, 1.0, 0, 0.0, 0.0, 2.0, 350.0, 90.0,
             {0.25, 0.25}, {0.071, 0.083}, {0.0, 0.0}, {3.3, 2.6}, {1, 1},
             2, {0.0, 0.0}, {3.3, 2.6}, 5, 140, 707, 0, 140}; cfgs.push_back(c); }
  // 8. 1-D well-tempered UNDER per-round capping (seq): every cycle's hill
  //    integral (~h * sigma*sqrt(2)*sqrt(pi) ~ 0.0075) crosses
  //    bias_per_step, exercising partial undo + drain-first + skip
  //    interleaved with tempered heights, exactly (round size 1)
  { Cfg c = {"wtcap1d", 1, 0.91, 1.0, 1, 8.0, -1.0, 6.0, 0.005, 0.0,
             {0.15, 0}, {0.0209, 0}, {0.0, 0}, {2.8, 0}, {1, 0},
             0, {0.0, 0}, {2.8, 0}, 7, 100, 808, 1, 300}; cfgs.push_back(c); }
  // 9. 1-D well-tempered BATCH rounds (seq=0, strong tempering): the
  //    reference tempers each hill of a multi-hill round against the LIVE
  //    grid including same-round deposits (edm_bias.cpp:547-550).  Pins the
  //    engine's n_passes="live" (one-hill-per-pass) mode exactly; the
  //    batched round-start approximation's divergence is measured against
  //    this fixture and bounded (test_oracle_sweep.py).
  { Cfg c = {"wtbatch1d", 1, 1.19, 1.0, 1, 6.0, -1.0, 8.0, 500.0, 0.0,
             {0.14, 0}, {0.0211, 0}, {0.0, 0}, {3.0, 0}, {1, 0},
             0, {-0.3, 0}, {3.3, 0}, 6, 24, 909, 0, 120}; cfgs.push_back(c); }
  // 10. 2-D mixed-periodicity well-tempered batch rounds (no capping:
  //     any deferral makes the reference's next drain read uninitialized
  //     overflow-buffer slot 0 — the Q3 pre-incremented cursor,
  //     edm_bias.cpp:513-517 — giving garbage-dependent fixtures; the
  //     cap-chain-across-passes machinery is pinned instead by replaying
  //     the deterministic captgt1d fixture in live mode)
  { Cfg c = {"wtbatch2d", 2, 1.07, 1.0, 1, 5.0, -1.0, 4.0, 300.0, 0.0,
             {0.22, 0.25}, {0.064, 0.079}, {0.0, -0.8}, {2.8, 1.7}, {1, 0},
             0, {-0.2, -0.9}, {3.0, 1.8}, 5, 16, 1010, 0, 100}; cfgs.push_back(c); }

  for (size_t ci = 0; ci < cfgs.size(); ci++) {
    const Cfg& c = cfgs[ci];
    srand(c.seed);

    // ---- write the .edm the reference will read
    std::string edm_body;
    char line[512];
    snprintf(line, sizeof(line), "tempering %d\n", c.tempering);
    edm_body += line;
    if (c.tempering) {
      snprintf(line, sizeof(line), "bias_factor %.17g\n", c.bias_factor);
      edm_body += line;
      if (c.global_tempering != 0.0) {
        snprintf(line, sizeof(line), "global_tempering %.17g\n",
                 c.global_tempering);
        edm_body += line;
      }
    }
    snprintf(line, sizeof(line), "hill_prefactor %.17g\n", c.prefactor);
    edm_body += line;
    if (c.bias_per_step > 0) {
      snprintf(line, sizeof(line), "bias_per_step %.17g\n", c.bias_per_step);
      edm_body += line;
    }
    if (c.hill_density != 0.0) {
      snprintf(line, sizeof(line), "hill_density %.17g\n", c.hill_density);
      edm_body += line;
    }
    snprintf(line, sizeof(line), "dimension %d\n", c.dim);
    edm_body += line;
    edm_body += "bias_spacing";
    for (int d = 0; d < c.dim; d++) {
      snprintf(line, sizeof(line), " %.17g", c.spacing[d]);
      edm_body += line;
    }
    edm_body += "\nbias_sigma";
    for (int d = 0; d < c.dim; d++) {
      snprintf(line, sizeof(line), " %.17g", c.sigma[d]);
      edm_body += line;
    }
    edm_body += "\nbox_low";
    for (int d = 0; d < c.dim; d++) {
      snprintf(line, sizeof(line), " %.17g", c.lo[d]);
      edm_body += line;
    }
    edm_body += "\nbox_high";
    for (int d = 0; d < c.dim; d++) {
      snprintf(line, sizeof(line), " %.17g", c.hi[d]);
      edm_body += line;
    }
    edm_body += "\n";

    std::string target_text;
    std::string edm_full = edm_body;
    if (c.target_kind) {
      std::string tpath = make_target(c, tmpdir);
      target_text = read_file(tpath);
      edm_full += "target_filename " + tpath + "\n";
    }
    edm_full += "hills_filename " + tmpdir + "/SWHILLS_" + c.name + "\n";
    std::string epath = tmpdir + "/sw_" + c.name + ".edm";
    FILE* f = fopen(epath.c_str(), "w");
    fputs(edm_full.c_str(), f);
    fclose(f);

    // ---- run the reference
    EDMBias bias(epath);
    bias.setup(c.T, c.kB);
    double lo3[3] = {0, 0, 0}, hi3[3] = {0, 0, 0}, skin[3] = {0, 0, 0};
    int per3[3] = {0, 0, 0};
    for (int d = 0; d < c.dim; d++) {
      lo3[d] = c.lo[d]; hi3[d] = c.hi[d]; per3[d] = c.periodic[d];
    }
    bias.subdivide(lo3, hi3, lo3, hi3, per3, skin);

    std::string opath = outdir + "/sweep_" + c.name + ".txt";
    FILE* out = fopen(opath.c_str(), "w");
    if (!out) { fprintf(stderr, "cannot open %s\n", opath.c_str()); return 1; }
    fprintf(out, "NAME %s\nTEMP %.17g %.17g\nDIM %d\nPERIODIC", c.name, c.T,
            c.kB, c.dim);
    for (int d = 0; d < c.dim; d++) fprintf(out, " %d", c.periodic[d]);
    fprintf(out, "\nBOX");
    for (int d = 0; d < c.dim; d++) fprintf(out, " %.17g", c.lo[d]);
    for (int d = 0; d < c.dim; d++) fprintf(out, " %.17g", c.hi[d]);
    fprintf(out, "\n");
    {
      int nl = 0;
      for (size_t i = 0; i < edm_body.size(); i++)
        if (edm_body[i] == '\n') nl++;
      fprintf(out, "EDM %d\n%s", nl, edm_body.c_str());
    }
    if (c.target_kind) {
      int nl = 0;
      for (size_t i = 0; i < target_text.size(); i++)
        if (target_text[i] == '\n') nl++;
      fprintf(out, "TARGET %d\n%s", nl, target_text.c_str());
    }

    fprintf(out, "EST %d\n", c.est);
    for (int round = 0; round < c.rounds; round++) {
      if (c.seq) {
        // one pre/add/post cycle per hill — exact sequential tempering
        for (int i = 0; i < c.hills; i++) {
          double x[2];
          for (int d = 0; d < c.dim; d++)
            x[d] = c.slo[d] + (c.shi[d] - c.slo[d]) * urand();
          double u = urand();
          bias.pre_add_hill(c.est);
          fprintf(out, "ROUND 1\nH");
          for (int d = 0; d < c.dim; d++) fprintf(out, " %.17g", x[d]);
          fprintf(out, " %.17g\n", u);
          bias.add_hill(x, u);
          bias.post_add_hill();
          fprintf(out, "CUM %.15g\n", bias.cum_bias_);
        }
      } else {
        bias.pre_add_hill(c.est);
        fprintf(out, "ROUND %d\n", c.hills);
        for (int i = 0; i < c.hills; i++) {
          double x[2];
          for (int d = 0; d < c.dim; d++)
            x[d] = c.slo[d] + (c.shi[d] - c.slo[d]) * urand();
          double u = urand();
          fprintf(out, "H");
          for (int d = 0; d < c.dim; d++) fprintf(out, " %.17g", x[d]);
          fprintf(out, " %.17g\n", u);
          bias.add_hill(x, u);
        }
        bias.post_add_hill();
        fprintf(out, "CUM %.15g\n", bias.cum_bias_);
      }
    }

    // ---- probes: interpolated bias values on an interior lattice
    if (c.dim == 1) {
      int np = 41;
      fprintf(out, "PROBES %d\n", np);
      double w = c.hi[0] - c.lo[0];
      for (int k = 0; k < np; k++) {
        double q = c.lo[0] + w * (0.015 + 0.97 * k / (np - 1));
        fprintf(out, "P %.17g %.15g\n", q, bias.bias_->get_value(&q));
      }
    } else {
      int nx = 7, ny = 7;
      fprintf(out, "PROBES %d\n", nx * ny);
      double wx = c.hi[0] - c.lo[0], wy = c.hi[1] - c.lo[1];
      for (int a = 0; a < nx; a++)
        for (int b = 0; b < ny; b++) {
          double q[2] = {c.lo[0] + wx * (0.02 + 0.96 * a / (nx - 1)),
                         c.lo[1] + wy * (0.02 + 0.96 * b / (ny - 1))};
          fprintf(out, "P %.17g %.17g %.15g\n", q[0], q[1],
                  bias.bias_->get_value(q));
        }
    }
    fprintf(out, "END\n");
    fclose(out);
    printf("%s: cum=%.12f\n", c.name, bias.cum_bias_);
  }
  return 0;
}
