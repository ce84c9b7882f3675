"""Online tuning of the serving path: the per-slot speculative draft
length (:mod:`.spec_adapt`)."""
