"""The fracture pipeline (prepare_fracture)."""
