"""Progress, timing, and frame / VTK output."""
