// Planner oracle: runs the REFERENCE RAPPIDS planner (DepthImagePlanner.cpp
// compiled unmodified from /root/reference) on depth images + candidate
// sets produced by the JAX framework, so planner/rappids.py can be
// compared head-to-head against the true reference geometry
// (VERDICT r4 #2: seq_oracle reuses the framework's own kernels, so a
// geometry bug is invisible to it by construction; this harness is not).
//
// Modes:
//   inject  evaluate an EXPLICIT candidate list (px, py, depth, tf) through
//           the exact anytime loop (FindLowestCostTrajectory with a huge
//           time budget + list-injection generator mirroring
//           RandomTrajectoryGenerator::GetNextCandidateTrajectory), then an
//           exhaustive per-candidate pass (IsCollisionFree with the timer
//           reset, like MeasureConservativeness) + the reference's own
//           ray-tracing ground truth. Per-candidate CSV out.
//   budget  free-running FindLowestCostTrajectory with the reference's own
//           RandomTrajectoryGenerator at a real wall-clock budget (the
//           15 ms of ExampleVehicleStateMachine.cpp:183 or the demo's
//           50 ms) — used for quality-at-budget comparisons.
//
// Inputs are binary/CSV files; all state vectors are CAMERA-frame, exactly
// as Rappids_Simulator/main.cpp:484-503 hands them to the planner. The
// cost mirrors ExplorationCost::GetTrajCost (main.cpp:95-109) with the
// goal already rotated into the camera frame: -(|G_C| - |G_C - end|)/tf.
//
// Usage:
//   planner_oracle inject <depth.bin> <w> <h> <depthScale> <focal>
//                  <statefile> <cands.csv> <out.csv>
//   planner_oracle budget <depth.bin> <w> <h> <depthScale> <focal>
//                  <statefile> <seed> <budget_s> <out.csv>
//   planner_oracle conserv <depth.bin> <w> <h> <depthScale> <focal>
//                  <statefile> <numTraj> <pyramidLimit>
//
// statefile: one line: vx vy vz ax ay az gx gy gz goalx goaly goalz
//            physRadius planRadius minCollDist

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <opencv2/core.hpp>

#define private public
#define protected public
#include "Components/DepthImagePlanner/DepthImagePlanner.hpp"
#undef private
#undef protected

using namespace CommonMath;
using namespace RectangularPyramidPlanner;
using RapidQuadrocopterTrajectoryGenerator::RapidTrajectoryGenerator;

struct CamState {
  Vec3d vel, acc, grav, goal;
  double physR, planR, minColl;
};

static CamState readState(const char* path) {
  FILE* f = fopen(path, "r");
  if (!f) { fprintf(stderr, "cannot open %s\n", path); exit(1); }
  CamState s;
  if (fscanf(f, "%lf %lf %lf %lf %lf %lf %lf %lf %lf %lf %lf %lf %lf %lf %lf",
             &s.vel.x, &s.vel.y, &s.vel.z, &s.acc.x, &s.acc.y, &s.acc.z,
             &s.grav.x, &s.grav.y, &s.grav.z, &s.goal.x, &s.goal.y,
             &s.goal.z, &s.physR, &s.planR, &s.minColl) != 15) {
    fprintf(stderr, "bad statefile\n"); exit(1);
  }
  fclose(f);
  return s;
}

static cv::Mat readDepth(const char* path, int w, int h) {
  cv::Mat img(h, w, CV_16UC1);
  FILE* f = fopen(path, "rb");
  if (!f) { fprintf(stderr, "cannot open %s\n", path); exit(1); }
  if (fread(img.data, 2, size_t(w) * h, f) != size_t(w) * h) {
    fprintf(stderr, "short depth read\n"); exit(1);
  }
  fclose(f);
  return img;
}

struct ExplorationCostCam {
  Vec3d goalCam;
  static double Wrap(void* p, RapidTrajectoryGenerator& traj) {
    ExplorationCostCam* c = (ExplorationCostCam*) p;
    double tf = traj.GetFinalTime();
    Vec3d end = traj.GetPosition(tf);
    double SG = c->goalCam.GetNorm2();
    double PiG = (c->goalCam - end).GetNorm2();
    return -(SG - PiG) / tf;
  }
};

// list-injection generator: replays an explicit (px, py, depth, tf) list
// through the exact construction of
// RandomTrajectoryGenerator::GetNextCandidateTrajectory (hpp:393-404)
struct ListGenerator {
  DepthImagePlanner* planner;
  std::vector<double> px, py, depth, tf;
  size_t i = 0;
  static int Wrap(void* p, RapidTrajectoryGenerator& nextTraj) {
    ListGenerator* g = (ListGenerator*) p;
    if (g->i >= g->px.size()) return -1;
    Vec3d posf;
    g->planner->DeprojectPixelToPoint(g->px[g->i], g->py[g->i],
                                      g->depth[g->i], posf);
    nextTraj.Reset();
    nextTraj.SetGoalPosition(posf);
    nextTraj.SetGoalVelocity(Vec3d(0, 0, 0));
    nextTraj.SetGoalAcceleration(Vec3d(0, 0, 0));
    nextTraj.Generate(g->tf[g->i]);
    g->i++;
    return 0;
  }
};

int main(int argc, char** argv) {
  if (argc < 8) {
    fprintf(stderr, "usage: see header comment\n");
    return 2;
  }
  const std::string mode = argv[1];
  const int w = atoi(argv[3]);
  const int h = atoi(argv[4]);
  const double scale = atof(argv[5]);
  const double focal = atof(argv[6]);
  cv::Mat depth = readDepth(argv[2], w, h);
  CamState st = readState(argv[7]);

  DepthImagePlanner planner(depth, scale, focal, w / 2.0, h / 2.0,
                            st.physR, st.planR, st.minColl);
  ExplorationCostCam cost{st.goal};
  RapidTrajectoryGenerator traj(Vec3d(0, 0, 0), st.vel, st.acc, st.grav);

  if (mode == "inject") {
    ListGenerator gen;
    gen.planner = &planner;
    FILE* f = fopen(argv[8], "r");
    if (!f) { fprintf(stderr, "cannot open %s\n", argv[8]); return 1; }
    double a, b, c, d;
    while (fscanf(f, "%lf,%lf,%lf,%lf", &a, &b, &c, &d) == 4) {
      gen.px.push_back(a); gen.py.push_back(b);
      gen.depth.push_back(c); gen.tf.push_back(d);
    }
    fclose(f);

    std::vector<TrajectoryTest> tests;
    bool found = planner.FindLowestCostTrajectory(
        traj, tests, 1e3, (void*) &cost, &ExplorationCostCam::Wrap,
        (void*) &gen, &ListGenerator::Wrap);

    // exhaustive per-candidate pass (timer reset per check, pyramids keep
    // accumulating — MeasureConservativeness's discipline, cpp:972-1002)
    FILE* out = fopen(argv[9], "w");
    fprintf(out, "idx,resultbits,cost,feas,velok,cf_exhaustive,gt_free\n");
    for (size_t i = 0; i < tests.size(); i++) {
      RapidTrajectoryGenerator ci(tests[i].traj);
      double c = ExplorationCostCam::Wrap(&cost, ci);
      int feas = int(ci.CheckInputFeasibility(
          planner._minimumAllowedThrust, planner._maximumAllowedThrust,
          planner._maximumAllowedAngularVelocity,
          planner._minimumSectionTimeDynamicFeas));
      int velok = int(ci.CheckVelocityFeasibility(
          planner._maximumAllowedVelocity)
          == RapidTrajectoryGenerator::StateFeasibilityResult::StateFeasible);
      planner._startTime = std::chrono::high_resolution_clock::now();
      bool cf = planner.IsCollisionFree(ci.GetTrajectory());
      bool gt = planner.IsCollisionFreeGroundTruth(ci.GetTrajectory());
      fprintf(out, "%zu,%d,%.17g,%d,%d,%d,%d\n", i, int(tests[i].result), c,
              feas, velok, int(cf), int(gt));
    }
    fclose(out);
    double tf = traj.GetFinalTime();
    Vec3d e = found ? traj.GetPosition(tf) : Vec3d(0, 0, 0);
    printf("found %d ncand %zu best_cost %.17g best_end %.17g %.17g %.17g "
           "best_tf %.17g npyr %zu\n",
           int(found), tests.size(),
           found ? ExplorationCostCam::Wrap(&cost, traj) : 0.0,
           e.x, e.y, e.z, found ? tf : 0.0, planner.GetPyramids().size());
  } else if (mode == "budget") {
    const int seed = atoi(argv[8]);
    const double budget = atof(argv[9]);
    planner.SetRandomSeed(seed);
    DepthImagePlanner::RandomTrajectoryGenerator gen(&planner);
    std::vector<TrajectoryTest> tests;
    bool found = planner.FindLowestCostTrajectory(
        traj, tests, budget, (void*) &cost, &ExplorationCostCam::Wrap,
        (void*) &gen,
        &DepthImagePlanner::RandomTrajectoryGenerator::GetNextCandidateTrajectoryWrapper);
    double tf = traj.GetFinalTime();
    Vec3d e = found ? traj.GetPosition(tf) : Vec3d(0, 0, 0);
    printf("found %d ncand %d best_cost %.17g best_end %.17g %.17g %.17g "
           "best_tf %.17g npyr %zu gt_free_best %d\n",
           int(found), planner.GetNumTrajectoriesGenerated(),
           found ? ExplorationCostCam::Wrap(&cost, traj) : 0.0,
           e.x, e.y, e.z, found ? tf : 0.0, planner.GetPyramids().size(),
           found ? int(planner.IsCollisionFreeGroundTruth(traj.GetTrajectory()))
                 : -1);
  } else if (mode == "conserv") {
    const int n = atoi(argv[8]);
    const int pyrLimit = atoi(argv[9]);
    int wrong = 0, right = 0;
    planner.MeasureConservativeness(n, pyrLimit, traj, wrong, right);
    printf("n %d incorrect_in_collision %d correct_in_collision %d\n",
           n, wrong, right);
  } else {
    fprintf(stderr, "unknown mode %s\n", mode.c_str());
    return 2;
  }
  return 0;
}
