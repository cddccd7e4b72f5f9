"""Material ids, scene bundle, scene builders and the fast 2D and 3D solvers."""
