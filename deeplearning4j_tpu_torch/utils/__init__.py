"""Small shared helpers: the cross-thread error latch
(:mod:`.concurrent`)."""
