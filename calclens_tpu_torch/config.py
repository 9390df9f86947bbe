"""Run-time configuration: reference-compatible tag-value files -> dataclass.

Parses the same ``raytrace.cfg`` format as the reference (config.c:20-226):
whitespace-separated ``Tag value`` lines, ``#`` comments, unknown tags warn.
The reference's compile-time ``-D`` switches (Makefile:1-27) become runtime
fields here (SURVEY.md section 2.9).

The port's own copy of calclens_tpu/config.py (the port imports nothing of
the JAX package); the two must parse a file alike
(tests/test_torch_copies.py).
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from dataclasses import dataclass, field


@dataclass
class RayTraceConfig:
    # wall clock control (reference config.c ASSIGN_CONFIG_DOUBLE)
    WallTimeLimit: float = 1e30
    WallTimeBetweenRestart: float = 1e30

    # output
    OutputPath: str = ""
    RayOutputName: str = ""
    NumRayOutputFiles: int = 1
    NumFilesIOInParallel: int = 1

    # cosmology / lens planes
    OmegaM: float = 0.3
    maxComvDistance: float = 0.0
    NumLensPlanes: int = 0
    LensPlanePath: str = ""
    LensPlaneName: str = ""
    LensPlaneType: str = ""

    # precomputed HEALPix mass-map planes (UseHEALPixLensPlaneMaps path)
    HEALPixLensPlaneMapPath: str = ""
    HEALPixLensPlaneMapName: str = ""
    HEALPixLensPlaneMapOrder: int = -1
    partMass: float = -1.0

    # resolution / region
    bundleOrder: int = 5
    rayOrder: int = 8
    minRa: float = 0.0
    maxRa: float = 360.0
    minDec: float = -90.0
    maxDec: float = 90.0

    # SHT
    SHTOrder: int = 7
    LMax: int = -1                    # band limit; -1 = 3*nside - 1
    HEALPixRingWeightPath: str = ""
    HEALPixWindowFunctionPath: str = ""

    # smoothing / balance / multigrid
    ComvSmoothingScale: float = -1.0
    maxRayMemImbalance: float = 0.25
    MGConvFact: float = -1.0

    # 3D potential mode
    MaxNFFT: int = -1
    NFFT: int = -1
    ThreeDPotSnapList: str = ""
    LengthConvFact: float = -1.0

    # galaxies / maps / CMB
    GalsFileList: str = ""
    GalOutputName: str = ""
    NumGalOutputFiles: int = 1
    MapRedshiftList: str = ""
    CMBLensing: int = 0
    MaxResMap: int = 0
    # framework extension: order of the Convergence_/Rays_ lens-map outputs.
    # -1 = the reference's hardcoded map_order = 11 (raytrace.c:44); small
    # values keep test/debug runs from writing multi-GB map tables
    LensMapOrder: int = -1
    # CMB-mode output switches (the reference's compile consts
    # write_restart_files_for_rays_at_cmb / write_fits_maps_for_rays_at_cmb,
    # both true, propagate_to_cmb_from_restart.c:203-204); CMBMapOrder -1 =
    # the reference's hardcoded order 12 (propagate_to_cmb_from_restart.c:208)
    WriteRaysAtCMB: int = 1
    WriteCMBMaps: int = 1
    CMBMapOrder: int = -1

    # point-mass / NFW analytic test parameters (reference raytrace.h fields
    # used by make_lensplanes_pointmass_test)
    raPointMass: float = 0.0
    decPointMass: float = 0.0
    radPointMass: float = 0.0
    galRadPointNFWTest: float = 0.0

    # --- runtime flags replacing the reference's compile-time -D switches ---
    SHTOnly: bool = True              # SHTONLY (Makefile:6)
    UseFullSkyPartDist: bool = True   # USE_FULLSKY_PARTDIST (Makefile:7)
    DepositScheme: str = "NGP"        # NGPSHTDENS | CICSHTDENS | SPH (Makefile:26)
    BornApprx: bool = False           # BORNAPPRX
    OutputRayDeflections: bool = False
    OutputPhi: bool = False
    ThreeDPot: bool = False           # THREEDPOT
    NoBackDens: bool = False          # NOBACKDENS (set by the analytic tests)
    PointMassTest: bool = False       # POINTMASSTEST
    NFWHaloTest: bool = False         # NFWHALOTEST
    RayOutputFormat: str = "fits"     # USE_FITS_RAYOUT vs binary

    DebugIO: bool = False             # DEBUG_IO map dumps per plane
    KeepRandFrac: float = 1.0         # KEEP_RAND_FRAC particle subsampling
    DebugNans: bool = False           # FP-trap analog (DEF_GSL_IEEE_ENV)

    # --- TPU runtime extras (no reference analog) ---
    Precision: str = "f32"            # f32 | f64 device compute dtype
    MeshShape: str = ""               # e.g. "8" or "4x2" for the SHT mesh
    SmoothingBeamFWHM: float = 0.0    # Gaussian l-space beam FWHM [rad]; 0 = off
    Profile: bool = False             # per-phase timing rows (profile.c analog):
    # splits the fused plane step at phase boundaries with device syncs, so
    # steps are a few % slower but timing.0 gains reference-style columns

    # derived (filled by finalize)
    UseHEALPixLensPlaneMaps: bool = False
    CurrentPlaneNum: int = 0
    CurrentMapNum: int = 0

    def finalize(self):
        """Validation + derived fields (reference config.c:178-226)."""
        assert self.maxRayMemImbalance > 0.0
        assert self.NumLensPlanes > 0, "NumLensPlanes must be set"
        assert self.maxComvDistance > 0.0, "maxComvDistance must be set"
        assert 0.0 < self.OmegaM < 1.0
        assert self.rayOrder >= self.bundleOrder, "rayOrder must be >= bundleOrder"
        if self.HEALPixLensPlaneMapOrder >= 0 and self.HEALPixLensPlaneMapPath:
            self.UseHEALPixLensPlaneMaps = True
        if self.PointMassTest or self.NFWHaloTest:
            self.NoBackDens = True  # Makefile:150-156
        assert self.DepositScheme in ("NGP", "CIC", "SPH")
        return self

    @property
    def poissonOrder(self) -> int:
        return (
            self.HEALPixLensPlaneMapOrder if self.UseHEALPixLensPlaneMaps else self.SHTOrder
        )

    def to_cfg(self) -> str:
        """Serialize in reference tag-value format."""
        lines = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, bool):
                v = int(v)
            if v == "":  # empty strings are unrepresentable in tag-value form
                continue
            lines.append(f"{f.name} {v}")
        return "\n".join(lines) + "\n"


_BOOL_FIELDS = {
    f.name for f in dataclasses.fields(RayTraceConfig) if f.type in ("bool", bool)
}


def read_config(path: str) -> RayTraceConfig:
    """Parse a reference-format config file (config.c:20)."""
    cfg = RayTraceConfig()
    fields = {f.name: f for f in dataclasses.fields(RayTraceConfig)}
    lower = {k.lower(): k for k in fields}
    with open(path) as fp:
        for raw in fp:
            line = raw.replace("\t", " ").strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 2:
                # the reference's example config carries empty-valued string
                # tags (raytrace.cfg:14,44-45): keep the default
                tag, val = parts[0], ""
            else:
                tag, val = parts[0], parts[1]
            key = lower.get(tag.lower())
            if key is None:
                warnings.warn(f"Tag-value pair ('{tag}','{val}') not recognized in '{path}'")
                continue
            ftype = fields[key].type
            if val == "" and ftype not in ("str", str):
                continue  # empty non-string tag: keep the default
            if key in _BOOL_FIELDS:
                setattr(cfg, key, bool(int(val)))
            elif ftype in ("int", int):
                setattr(cfg, key, int(val))
            elif ftype in ("float", float):
                setattr(cfg, key, float(val))
            else:
                setattr(cfg, key, val)
    cfg.finalize()
    # echo usedvalues next to outputs like the reference (config.c:57,174)
    if cfg.OutputPath:
        os.makedirs(cfg.OutputPath, exist_ok=True)
        with open(os.path.join(cfg.OutputPath, "raytrace.cfg-usedvalues"), "w") as fp:
            fp.write(cfg.to_cfg())
    return cfg
