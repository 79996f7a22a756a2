"""The device mesh and the sharded programs over it (:mod:`.mesh`)."""
