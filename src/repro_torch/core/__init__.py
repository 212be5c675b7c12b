"""Framework-free quorum systems (a copy of ``repro.core.quorum``)."""
