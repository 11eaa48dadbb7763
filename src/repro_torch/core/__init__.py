"""Paper core, host side: staleness models, step-size strategies, estimator."""
