"""Answers delivered in the window a second of it (the host's clock): the
rate an analyst's session sees, per layer because the host's pace spreads
it from process to process by more than an end-to-end bound can hold."""


def read(record: dict):
    return record["e2e"]["answers_per_s"]
