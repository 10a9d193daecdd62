"""Global constants (counterpart of iris_tpu/const.py).

GAMMA=2.2 and SEED=0 as in the reference; RAY_EPS plays the role of
mitsuba.math.RayEpsilon for shadow/self-intersection offsets.
"""

GAMMA = 2.2
SEED = 0

# mitsuba's RayEpsilon = eps * 1500 with eps = 2^-23  ->  ~1.788e-4.
RAY_EPS = 1.788139e-4
