"""Krylov solvers on flat f32 vectors."""
