"""Helpers around the solver: domain masks for flag matrices (``geometry``)
and domain-wide fluid and particle statistics (``fluidinfo``)."""
