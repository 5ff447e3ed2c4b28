"""K1 launches a pass: the program's counter ``segdp_cuda.LAUNCHES``, read
before and after each of the window's passes, averaged over them."""


def read(run):
    got = [p.k1_launches for p in run.passes if p.ok]
    return sum(got) / len(got) if got else None
