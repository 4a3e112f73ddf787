"""dissect_img_per_s: probe images of all jobs of the window over the whole window,
each job from the `run_dissection` call to its written CSV."""


def read(run):
    return run.window.rate()
