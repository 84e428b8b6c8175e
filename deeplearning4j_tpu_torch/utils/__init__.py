"""Small shared helpers: the cross-thread error latch
(:mod:`.concurrent`) and the runtime environment (:mod:`.environment`)."""
