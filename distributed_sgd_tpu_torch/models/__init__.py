"""Linear models on flat f32[D] weights."""
