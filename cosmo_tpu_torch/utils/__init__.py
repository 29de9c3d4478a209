"""Console output of the solver (:mod:`.printing`)."""
