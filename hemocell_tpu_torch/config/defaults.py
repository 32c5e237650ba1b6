"""Framework-wide constants.

The reference's compile-time flags that the ported main path reads
(reference: config/constant_defaults.h:29-191), kept as module constants;
stability clamps are part of the validated material models and must not be
changed lightly.
"""

# Stability clamps for the high-order membrane models
# (reference: config/constant_defaults.h:154-175)
MAX_CELL_VOLUMETRIC_CHANGE = 0.01
MAX_CELL_SURFACE_AREA_CHANGE = 0.09
MAX_CELL_BENDING_ANGLE = 0.0555
MAX_PLT_BENDING_ANGLE = 2.467
MAX_CELL_PERSISTENCE_LENGTH = 9.0

# Force cap applied when spreading particle forces to the fluid, in pN
# (reference: config/constant_defaults.h:74, applied at
#  core/hemoCellParticleField.cpp:848-852)
FORCE_LIMIT_PN = 50.0

# Biological persistence length used in kLink conversion [m]
# (reference: mechanics/cellMechanics.h:52)
PERSISTENCE_LENGTH_FINE = 7.5e-9

# Reference eq length for kBend/kVolume/kArea conversions [m]
# (reference: mechanics/cellMechanics.h:58-73)
EQ_LENGTH_REF = 5e-7

# Face-count normalisation in kVolume/kArea (reference: cellMechanics.h:65)
NFACES_REF = 1280.0

# Flag-matrix node kinds (uint8 lattice flags)
FLAG_FLUID = 0
FLAG_WALL = 1  # bounce-back
FLAG_VELOCITY = 2  # prescribed-velocity (equilibrium) node
FLAG_PRESSURE = 3  # fixed-density (anti-bounce-back) outlet node

