"""Aten operators the closed loop dispatches a round, counted by a dispatch
mode over a fixed stretch of rounds after the window (views included;
the server's admission, retirement and the submissions count too)."""


def read(record: dict):
    aten = record["aten"]
    if not aten or not aten["rounds"]:
        return None
    return aten["ops"] / aten["rounds"]
