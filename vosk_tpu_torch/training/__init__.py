"""In-process training: the flat-start GMM aligner and the recipe (port of
`vosk_tpu/training`)."""
