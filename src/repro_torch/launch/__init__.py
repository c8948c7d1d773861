"""Step builders of the port (the counterpart of ``repro.launch``)."""
