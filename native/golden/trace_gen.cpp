// Golden-trace generator: runs the REFERENCE C++ physics/logic/estimator
// stack (compiled unmodified from /root/reference) through the renderer-free
// core of Simulator/Rappids_Simulator/main.cpp:330-760 and dumps per-tick
// state so the JAX framework can be compared against the true reference
// semantics (BASELINE.md "trajectories bit-comparable vs the C++
// single-thread sim").
//
// Mirrored loop (same statement order as main.cpp):
//   quad->Run()                      [500 Hz physics + onboard logic]
//   simTimer.AdvanceMicroSeconds(2000)
//   [mocap timer > 5 ms]   est->UpdateWithMeasurement(truth pos, att)
//   [telem timer > 10 ms]  telemetry encode/decode roundtrip
//   estState = est->GetPrediction(0.03)
//   [offboard timer > 10 ms] ctrl.Run -> CreateRatesCommand -> radio queue,
//                            est->SetPredictedValues(...)
//   [radio channel ripe]   quad->SetCommandRadioMsg(...)
//
// IMU noise: Quadcopter_T draws 3 gyro + 3 acc unit normals per onboard
// tick from a default-constructed std::default_random_engine +
// std::normal_distribution<double>(0,1) (Quadcopter_T.cpp:159-183). A
// shadow engine/distribution pair here — default-constructed the same way
// and consumed in the same order, gated by shadow Timer instances running
// the exact integration/onboard-timer arithmetic of Quadcopter_T::Run
// (Quadcopter_T.cpp:86-203) — reproduces the identical draw values, which
// are dumped to noise.csv for bit-identical injection on the JAX side.
//
// Modes:
//   est    demo-faithful: MocapStateEstimator in the loop (config #2)
//   truth  offboard controller fed the true plant state (config #1)
//
// Usage: trace_gen <mode> <seconds> <outdir> [desx desy desz
//                  [step_t stepx stepy stepz]]
// The optional step block switches the desired position at t >= step_t
// (step-response config; the reference demo holds one setpoint).

#include <cinttypes>
#include <cstdio>
#include <cstring>
#include <memory>
#include <random>
#include <string>

#include <Eigen/Dense>

// Expose private sim internals (motor speeds, speed commands, the logic)
// for exact teacher-forced component tests on the framework side.  Test
// harness only — the reference sources themselves are compiled unmodified.
#define private public
#define protected public
#include "Common/Math/Vec3.hpp"
#include "Common/Math/Rotation.hpp"
#include "Common/Time/ManualTimer.hpp"
#include "Common/Time/Timer.hpp"
#include "Common/DataTypes/RadioTypes.hpp"
#include "Common/DataTypes/TelemetryPacket.hpp"
#include "Components/Simulation/Quadcopter_T.hpp"
#include "Components/Simulation/CommunicationsDelay.hpp"
#include "Components/Offboard/MocapStateEstimator.hpp"
#include "Components/Offboard/QuadcopterController.hpp"
#include "Components/Offboard/SafetyNet.hpp"
#include "Components/Logic/QuadcopterConstants.hpp"
#undef private
#undef protected

using namespace Offboard;

static void put3(FILE* f, Vec3d v) {
  fprintf(f, ",%.17g,%.17g,%.17g", v.x, v.y, v.z);
}
static void putq(FILE* f, Rotationd q) {
  fprintf(f, ",%.17g,%.17g,%.17g,%.17g", q[0], q[1], q[2], q[3]);
}
static void puthex(FILE* f, const uint8_t* b, int n) {
  fputc(',', f);
  for (int i = 0; i < n; i++) fprintf(f, "%02x", b[i]);
}

int main(int argc, char** argv) {
  if (argc < 4) {
    fprintf(stderr,
            "usage: %s <est|truth> <seconds> <outdir> [desx desy desz "
            "[step_t sx sy sz]]\n",
            argv[0]);
    return 2;
  }
  const std::string mode = argv[1];
  const double endTime = atof(argv[2]);
  const std::string outdir = argv[3];
  Vec3d desiredPosition(0, 0, 3.5);  // main.cpp:238
  if (argc >= 7) {
    desiredPosition = Vec3d(atof(argv[4]), atof(argv[5]), atof(argv[6]));
  }
  double stepTime = -1;
  Vec3d stepPosition(0, 0, 0);
  if (argc >= 11) {
    stepTime = atof(argv[7]);
    stepPosition = Vec3d(atof(argv[8]), atof(argv[9]), atof(argv[10]));
  }

  // ---- vehicle setup, verbatim parameterization (main.cpp:140-232) ----
  const double dt = 1.0 / 500.0;
  ManualTimer simTimer;

  uint8_t vehicleId = 1;
  Onboard::QuadcopterConstants::QuadcopterType quadcopterType =
      Onboard::QuadcopterConstants::GetVehicleTypeFromID(vehicleId);
  Onboard::QuadcopterConstants vehConsts(quadcopterType);
  const double mass = vehConsts.mass;
  const double inertia_xx = vehConsts.inertia_xx;
  const double inertia_yy = inertia_xx;
  const double inertia_zz = vehConsts.inertia_zz;
  const double armLength = vehConsts.armLength;
  const double propThrustFromSpeedSqr = vehConsts.propellerThrustFromSpeedSqr;
  const double propTorqueFromSpeedSqr =
      vehConsts.propellerTorqueFromThrust * vehConsts.propellerThrustFromSpeedSqr;
  const double motorTimeConst = vehConsts.motorTimeConst;
  const double motorInertia = vehConsts.motorInertia;
  const double motorMinSpeed = vehConsts.motorMinSpeed;
  const double motorMaxSpeed = vehConsts.motorMaxSpeed;
  const Vec3d centreOfMassError(0, 0, 0);

  const double periodMocapSystem = 1.0 / 200.0;
  const double periodOffboardMainLoop = 1.0 / 100.0;
  const double periodTelemetryLoop = 1.0 / 100.0;
  const double periodOnboardLogic = 1.0 / 500.0;
  const double timeDelayOffboardControlLoopTrue = 0.03;
  const double timeDelayOffboardControlLoopEstimate = 0.03;

  Eigen::Matrix<double, 3, 3> inertiaMatrix;
  inertiaMatrix << inertia_xx, 0, 0, 0, inertia_yy, 0, 0, 0, inertia_zz;
  Vec3d linDragCoeffB(vehConsts.linDragCoeffBx, vehConsts.linDragCoeffBy,
                      vehConsts.linDragCoeffBz);

  std::shared_ptr<Simulation::Quadcopter> quad(new Simulation::Quadcopter(
      &simTimer, mass, inertiaMatrix, armLength, centreOfMassError,
      motorMinSpeed, motorMaxSpeed, propThrustFromSpeedSqr,
      propTorqueFromSpeedSqr, motorTimeConst, motorInertia, linDragCoeffB,
      vehicleId, quadcopterType, periodOnboardLogic));

  // Shadow timing + RNG for the IMU noise draws (see header comment).
  // Constructed AFTER the quad, at the same master time (0), exactly like
  // the members inside Quadcopter_T.
  Timer shadowIntegration(&simTimer);
  Timer shadowOnboard(&simTimer);
  std::default_random_engine shadowGen;
  std::normal_distribution<double> shadowDist(0, 1);

  std::shared_ptr<MocapStateEstimator> est(new MocapStateEstimator(
      &simTimer, vehicleId, timeDelayOffboardControlLoopEstimate));
  QuadcopterController ctrl;
  SafetyNet safetyNet;
  ctrl.SetParameters(vehConsts.posControl_natFreq, vehConsts.posControl_damping,
                     vehConsts.attControl_timeConst_xy,
                     vehConsts.attControl_timeConst_z);

  const double desYawAngleDeg = 0;

  quad->SetPosition(Vec3d(0, 0, 0));
  quad->SetAttitude(Rotationd::Identity());

  Simulation::CommunicationsDelay<RadioTypes::RadioMessageDecoded::RawMessage>
      cmdRadioChannel(&simTimer, timeDelayOffboardControlLoopTrue);

  Timer t(&simTimer);
  Timer timerMocap(&simTimer);
  Timer timerOffboardMainLoop(&simTimer);
  Timer timerTelemetryLoop(&simTimer);

  FILE* ftrace = fopen((outdir + "/trace.csv").c_str(), "w");
  FILE* fnoise = fopen((outdir + "/noise.csv").c_str(), "w");
  FILE* foff = fopen((outdir + "/offboard.csv").c_str(), "w");
  FILE* ftel = fopen((outdir + "/telemetry.csv").c_str(), "w");
  FILE* fmot = fopen((outdir + "/motors.csv").c_str(), "w");
  // per-logic-tick onboard internals (teacher-forced stage-by-stage
  // comparison; uses the private-made-public members, test harness only)
  FILE* fdbg = fopen((outdir + "/logicdbg.csv").c_str(), "w");
  FILE* festd = fopen((outdir + "/estdbg.csv").c_str(), "w");
  if (!ftrace || !fnoise || !foff || !ftel || !fmot) {
    fprintf(stderr, "cannot open output files in %s\n", outdir.c_str());
    return 1;
  }
  fprintf(ftrace,
          "k,t_us,integrated,logic,mocap,telem,offboard,delivered,"
          "posx,posy,posz,velx,vely,velz,attw,attx,atty,attz,"
          "angvelx,angvely,angvelz,panic,fstate\n");
  fprintf(fnoise, "k,g0,g1,g2,a0,a1,a2\n");
  // per-tick motor/IMU dump for teacher-forced component tests:
  // s0..s3  exact post-Run motor speeds [rad/s, f64]
  // c0..c3  speed commands the motors will receive NEXT tick (f32, set at
  //         the last logic run)
  // g*/a*   exact f32 gyro/accelerometer measurements the logic consumed
  //         at its most recent run (from Quadcopter_T::GetRateGyro/
  //         GetAccelerometer)
  fprintf(fmot, "k,s0,s1,s2,s3,c0,c1,c2,c3,gx,gy,gz,ax,ay,az\n");
  fprintf(foff,
          "k,estposx,estposy,estposz,estvelx,estvely,estvelz,"
          "estattw,estattx,estatty,estattz,estangx,estangy,estangz,"
          "cmdthrust,cmdangx,cmdangy,cmdangz,desx,desy,desz,raw\n");
  fprintf(ftel, "k,p1,p2\n");
  fprintf(festd,
          "k,px,py,pz,vx,vy,vz,qw,qx,qy,qz,wx,wy,wz,"
          "vp00,vp01,vp11,va00,va01,va11,est_us\n");
  fprintf(fdbg,
          "k,fstate,r0,r1,r2,r3,glpx,glpy,glpz,alpx,alpy,alpz,"
          "biasx,biasy,biasz,kfax,kfay,kfaz,kfqw,kfqx,kfqy,kfqz,"
          "kfpx,kfpy,kfpz,kfvx,kfvy,kfvz\n");

  unsigned k = 0;
  while (t.GetSeconds<double>() < endTime) {
    // -- shadow the quad's internal integration/onboard-logic timing --
    bool integrated = false, logicFired = false;
    double noise6[6] = {0, 0, 0, 0, 0, 0};
    {
      const double sdt = shadowIntegration.GetSeconds<double>();
      if (!(sdt < 1e-6)) {  // Quadcopter_T.cpp:87-90
        shadowIntegration.Reset();
        integrated = true;
        if (shadowOnboard.GetSeconds<double>() > periodOnboardLogic) {
          shadowOnboard.AdjustTimeBySeconds(-periodOnboardLogic);
          logicFired = true;
          for (int i = 0; i < 6; i++) noise6[i] = shadowDist(shadowGen);
        }
      }
    }

    quad->Run();
    simTimer.AdvanceMicroSeconds(uint64_t(dt * 1e6));

    if (logicFired) {
      fprintf(fnoise, "%u,%.17g,%.17g,%.17g,%.17g,%.17g,%.17g\n", k, noise6[0],
              noise6[1], noise6[2], noise6[3], noise6[4], noise6[5]);
      auto& lg = quad->_logic;
      Rotationf kq = lg._kf.GetAttitude();
      fprintf(fdbg, "%u,%d,%.9g,%.9g,%.9g,%.9g", k, int(lg._state),
              double(lg._radioMessage.msg.floats[0]),
              double(lg._radioMessage.msg.floats[1]),
              double(lg._radioMessage.msg.floats[2]),
              double(lg._radioMessage.msg.floats[3]));
      Vec3f glp = lg._imuRateGyro.lowPass.GetValue();
      Vec3f alp = lg._imuAccelerometer.lowPass.GetValue();
      Vec3f bias = lg._gyroCalibrationBias;
      Vec3f ka = lg._kf.GetAngularVelocity();
      Vec3f kp = lg._kf.GetPosition();
      Vec3f kv = lg._kf.GetVelocity();
      fprintf(fdbg,
              ",%.9g,%.9g,%.9g,%.9g,%.9g,%.9g,%.9g,%.9g,%.9g"
              ",%.9g,%.9g,%.9g,%.9g,%.9g,%.9g,%.9g"
              ",%.9g,%.9g,%.9g,%.9g,%.9g,%.9g\n",
              double(glp.x), double(glp.y), double(glp.z), double(alp.x),
              double(alp.y), double(alp.z), double(bias.x), double(bias.y),
              double(bias.z), double(ka.x), double(ka.y), double(ka.z),
              double(kq[0]), double(kq[1]), double(kq[2]), double(kq[3]),
              double(kp.x), double(kp.y), double(kp.z), double(kv.x),
              double(kv.y), double(kv.z));
    }

    bool mocapFired = false;
    if (timerMocap.GetSeconds<double>() > periodMocapSystem) {
      timerMocap.AdjustTimeBySeconds(-periodMocapSystem);
      mocapFired = true;
      if (mode == "est") {
        Vec3d measPos(quad->GetPosition());
        Rotationd measAtt(quad->GetAttitude());
        est->UpdateWithMeasurement(measPos, measAtt);
        // post-update estimator internals (private-made-public; harness only)
        fprintf(festd, "%u", k);
        put3(festd, est->_pos);
        put3(festd, est->_vel);
        putq(festd, est->_att);
        put3(festd, est->_angVel);
        fprintf(festd, ",%.17g,%.17g,%.17g,%.17g,%.17g,%.17g,%" PRIu64 "\n",
                est->_variancePosition(0, 0), est->_variancePosition(0, 1),
                est->_variancePosition(1, 1), est->_varianceAttitude(0, 0),
                est->_varianceAttitude(0, 1), est->_varianceAttitude(1, 1),
                est->_estimateTimer.GetMicroSeconds());
      }
    }

    bool telemFired = false;
    if (timerTelemetryLoop.GetSeconds<double>() > periodTelemetryLoop) {
      timerTelemetryLoop.AdjustTimeBySeconds(-periodTelemetryLoop);
      telemFired = true;
      TelemetryPacket::data_packet_t p1, p2;
      quad->GetTelemetryDataPackets(p1, p2);
      TelemetryPacket::TelemetryPacket dataPacket;
      TelemetryPacket::DecodeTelemetryPacket(p1, dataPacket);
      TelemetryPacket::DecodeTelemetryPacket(p2, dataPacket);
      fprintf(ftel, "%u", k);
      puthex(ftel, reinterpret_cast<const uint8_t*>(&p1), sizeof p1);
      puthex(ftel, reinterpret_cast<const uint8_t*>(&p2), sizeof p2);
      fputc('\n', ftel);
    }

    EstimatedState estState;
    if (mode == "est") {
      estState = est->GetPrediction(timeDelayOffboardControlLoopEstimate);
    } else {
      estState.pos = quad->GetPosition();
      estState.vel = quad->GetVelocity();
      estState.att = quad->GetAttitude();
      estState.angVel = quad->GetAngularVelocity();
    }

    bool offboardFired = false;
    if (timerOffboardMainLoop.GetSeconds<double>() > periodOffboardMainLoop) {
      timerOffboardMainLoop.AdjustTimeBySeconds(-periodOffboardMainLoop);
      offboardFired = true;

      Vec3d desPos = desiredPosition;
      if (stepTime >= 0 && t.GetSeconds<double>() > stepTime) {
        desPos = stepPosition;
      }

      RadioTypes::RadioMessageDecoded::RawMessage rawMsg;
      safetyNet.UpdateWithEstimator(estState,
                                    est->GetTimeSinceLastGoodMeasurement());
      Vec3d cmdAngVel;
      double cmdThrust;
      uint8_t flags = 0;
      ctrl.Run(estState.pos, estState.vel, estState.att, desPos, Vec3d(0, 0, 0),
               Vec3d(0, 0, 0), desYawAngleDeg * M_PI / 180.0, cmdAngVel,
               cmdThrust);
      RadioTypes::RadioMessageDecoded::CreateRatesCommand(
          flags, float(cmdThrust), Vec3f(cmdAngVel), rawMsg.raw);
      if (mode == "est") {
        est->SetPredictedValues(
            cmdAngVel,
            (estState.att * Vec3d(0, 0, 1) * cmdThrust - Vec3d(0, 0, 9.81)));
      }
      // telemetry readout inside the offboard block (main.cpp:667-673) —
      // stateful on the logic (packet counter, warning reset), so keep it
      TelemetryPacket::data_packet_t p1, p2;
      quad->GetTelemetryDataPackets(p1, p2);
      TelemetryPacket::TelemetryPacket dataPacket;
      TelemetryPacket::DecodeTelemetryPacket(p1, dataPacket);
      TelemetryPacket::DecodeTelemetryPacket(p2, dataPacket);

      cmdRadioChannel.AddMessage(rawMsg);

      fprintf(foff, "%u", k);
      put3(foff, estState.pos);
      put3(foff, estState.vel);
      putq(foff, estState.att);
      put3(foff, estState.angVel);
      fprintf(foff, ",%.17g", cmdThrust);
      put3(foff, cmdAngVel);
      put3(foff, desPos);
      puthex(foff, rawMsg.raw, RadioTypes::RadioMessageDecoded::RAW_PACKET_SIZE);
      fputc('\n', foff);
    }

    bool delivered = false;
    if (cmdRadioChannel.HaveNewMessage()) {
      delivered = true;
      quad->SetCommandRadioMsg(cmdRadioChannel.GetMessage());
    }

    // per-tick truth row (state after this iteration's physics)
    fprintf(ftrace, "%u,%" PRIu64 ",%d,%d,%d,%d,%d,%d", k,
            t.GetMicroSeconds(), int(integrated), int(logicFired),
            int(mocapFired), int(telemFired), int(offboardFired),
            int(delivered));
    put3(ftrace, quad->GetPosition());
    put3(ftrace, quad->GetVelocity());
    putq(ftrace, quad->GetAttitude());
    put3(ftrace, quad->GetAngularVelocity());
    fprintf(ftrace, ",0,0\n");

    {
      // raw (pre-lowpass, pre-bias) f32 IMU measurements as stored by the
      // logic at its most recent run (_R is exactly identity for every
      // vehicle preset, so rawMeas equals the sim-side injected values
      // bit-for-bit) — NOT GetRateGyro/GetAccelerometer, which return the
      // lowpass outputs (QuadcopterLogic.hpp:72-76)
      Vec3f gy = quad->_logic._imuRateGyro.rawMeas;
      Vec3f ac = quad->_logic._imuAccelerometer.rawMeas;
      fprintf(fmot, "%u", k);
      for (int i = 0; i < 4; i++)
        fprintf(fmot, ",%.17g", quad->_motors[i]._speed);
      for (int i = 0; i < 4; i++)
        fprintf(fmot, ",%.9g", double(quad->_motorSpeedCommands[i]));
      fprintf(fmot, ",%.9g,%.9g,%.9g,%.9g,%.9g,%.9g\n", double(gy.x),
              double(gy.y), double(gy.z), double(ac.x), double(ac.y),
              double(ac.z));
    }
    k++;
  }

  fclose(festd);
  fclose(fdbg);
  fclose(ftrace);
  fclose(fnoise);
  fclose(foff);
  fclose(ftel);
  fclose(fmot);
  printf("wrote %u ticks to %s\n", k, outdir.c_str());
  return 0;
}
