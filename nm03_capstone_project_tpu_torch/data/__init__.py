"""Data layer: discovery, the DICOM reader and writer, synthetic cohorts."""
