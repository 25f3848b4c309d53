"""Serving of the port (:mod:`repro_torch.train.serve`); training is
ROADMAP A12c."""
