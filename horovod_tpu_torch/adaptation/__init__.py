"""Fault injection (:mod:`.faults`)."""
