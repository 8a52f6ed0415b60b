"""L5 models: scorers and the pairwise-SGD learners."""
