/* Native host runtime for light_loam_tpu.
 *
 * The reference's host-side runtime is C++ end to end; this build keeps
 * the compute path in XLA but implements the data path natively too:
 *
 *   - read_bin_padded: KITTI velodyne .bin (float32 x,y,z,intensity
 *     records, kittiHelper.cpp:22-32) -> pre-padded (capacity,3) float32
 *     xyz + (capacity,) intensity + valid count, in one pass with no
 *     intermediate copies, GIL released during file I/O.
 *   - write_kitti_pose: append one 3x4 row-major pose in the reference's
 *     "%e with 6 digits" format (laserMapping.cpp:2306-2325).
 *
 * Built as a CPython extension (no pybind11 in this image).
 */

#define PY_SSIZE_T_CLEAN
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <Python.h>
#include <numpy/arrayobject.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

static PyObject *
read_bin_padded(PyObject *self, PyObject *args)
{
    const char *path;
    Py_ssize_t capacity;
    if (!PyArg_ParseTuple(args, "sn", &path, &capacity))
        return NULL;
    if (capacity <= 0) {
        PyErr_SetString(PyExc_ValueError, "capacity must be positive");
        return NULL;
    }

    npy_intp xyz_dims[2] = {capacity, 3};
    npy_intp i_dims[1] = {capacity};
    PyArrayObject *xyz = (PyArrayObject *)PyArray_ZEROS(2, xyz_dims, NPY_FLOAT32, 0);
    PyArrayObject *inten = (PyArrayObject *)PyArray_ZEROS(1, i_dims, NPY_FLOAT32, 0);
    if (!xyz || !inten) {
        Py_XDECREF(xyz);
        Py_XDECREF(inten);
        return NULL;
    }
    float *xp = (float *)PyArray_DATA(xyz);
    float *ip = (float *)PyArray_DATA(inten);

    long n_read = 0;
    int err = 0;
    Py_BEGIN_ALLOW_THREADS
    {
        FILE *f = fopen(path, "rb");
        if (!f) {
            err = 1;
        } else {
            float rec[4 * 1024];
            size_t got;
            while ((got = fread(rec, sizeof(float), 4 * 1024, f)) > 0) {
                size_t n_pts = got / 4;
                for (size_t k = 0; k < n_pts; k++) {
                    if (n_read < capacity) {
                        xp[3 * n_read + 0] = rec[4 * k + 0];
                        xp[3 * n_read + 1] = rec[4 * k + 1];
                        xp[3 * n_read + 2] = rec[4 * k + 2];
                        ip[n_read] = rec[4 * k + 3];
                    }
                    n_read++;
                }
            }
            fclose(f);
        }
    }
    Py_END_ALLOW_THREADS

    if (err) {
        Py_DECREF(xyz);
        Py_DECREF(inten);
        PyErr_Format(PyExc_FileNotFoundError, "cannot open %s", path);
        return NULL;
    }
    long n_valid = n_read < capacity ? n_read : capacity;
    return Py_BuildValue("(NNll)", (PyObject *)xyz, (PyObject *)inten,
                         n_valid, n_read);
}

static PyObject *
write_kitti_pose(PyObject *self, PyObject *args)
{
    const char *path;
    PyObject *h_obj;
    if (!PyArg_ParseTuple(args, "sO", &path, &h_obj))
        return NULL;
    PyArrayObject *H = (PyArrayObject *)PyArray_FROM_OTF(
        h_obj, NPY_FLOAT64, NPY_ARRAY_IN_ARRAY);
    if (!H)
        return NULL;
    if (PyArray_NDIM(H) != 2 || PyArray_DIM(H, 0) < 3 || PyArray_DIM(H, 1) != 4) {
        Py_DECREF(H);
        PyErr_SetString(PyExc_ValueError, "pose must be (3..4, 4)");
        return NULL;
    }
    const double *hp = (const double *)PyArray_DATA(H);
    FILE *f = fopen(path, "a");
    if (!f) {
        Py_DECREF(H);
        PyErr_Format(PyExc_OSError, "cannot open %s for append", path);
        return NULL;
    }
    for (int r = 0; r < 3; r++) {
        for (int c = 0; c < 4; c++) {
            fprintf(f, "%.6e%s", hp[4 * r + c],
                    (r == 2 && c == 3) ? "\n" : " ");
        }
    }
    fclose(f);
    Py_DECREF(H);
    Py_RETURN_NONE;
}

static PyMethodDef Methods[] = {
    {"read_bin_padded", read_bin_padded, METH_VARARGS,
     "read_bin_padded(path, capacity) -> (xyz (cap,3) f32, intensity (cap,) "
     "f32, n_valid, n_total)"},
    {"write_kitti_pose", write_kitti_pose, METH_VARARGS,
     "write_kitti_pose(path, H (3x4 or 4x4 float64)) — append KITTI row"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_native", "native host runtime", -1, Methods,
};

PyMODINIT_FUNC
PyInit__native(void)
{
    import_array();
    return PyModule_Create(&moduledef);
}
