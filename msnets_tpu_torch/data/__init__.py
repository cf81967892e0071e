"""Host-side data of the port: PFM files, manifests, the train pipeline."""
