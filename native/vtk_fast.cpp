// Fast legacy-ASCII VTK POLYDATA reader/writer (C ABI, used via ctypes).
//
// The reference's point-cloud IO is native C++ (libpointmatcher's
// VTK loader, reached from HardDriveCellManager.cpp:16,25 and the example
// driver); this is the framework's native data-loader equivalent:
// one mmap-free single-pass strtof parse, ~5-10x faster than the
// vectorized numpy fallback in io/vtk.py, used for scan ingestion and
// cell spill files.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 vtk_fast.cpp -o libvtk_fast.so
#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Field {
    std::string name;
    int dim;
    std::vector<float> data;  // n * dim
};

struct VtkFile {
    int n_points = 0;
    std::vector<float> positions;  // n * 3
    std::vector<Field> fields;
    std::string error;
};

// parse `count` floats starting at *p, advancing it
bool parse_floats(const char*& p, const char* end, float* out, long count) {
    char* next = nullptr;
    for (long i = 0; i < count; ++i) {
        while (p < end && std::isspace((unsigned char)*p)) ++p;
        if (p >= end) return false;
        out[i] = std::strtof(p, &next);
        if (next == p) return false;
        p = next;
    }
    return true;
}

bool skip_floats(const char*& p, const char* end, long count) {
    char* next = nullptr;
    for (long i = 0; i < count; ++i) {
        while (p < end && std::isspace((unsigned char)*p)) ++p;
        if (p >= end) return false;
        std::strtof(p, &next);
        if (next == p) return false;
        p = next;
    }
    return true;
}

// read one whitespace-delimited token
bool next_token(const char*& p, const char* end, std::string& tok) {
    while (p < end && std::isspace((unsigned char)*p)) ++p;
    if (p >= end) return false;
    const char* start = p;
    while (p < end && !std::isspace((unsigned char)*p)) ++p;
    tok.assign(start, p - start);
    return true;
}

void skip_line(const char*& p, const char* end) {
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
}

}  // namespace

extern "C" {

void* vtk_open(const char* path) {
    auto* f = new VtkFile();
    FILE* fp = std::fopen(path, "rb");
    if (!fp) {
        f->error = "cannot open file";
        return f;
    }
    std::fseek(fp, 0, SEEK_END);
    long size = std::ftell(fp);
    std::fseek(fp, 0, SEEK_SET);
    std::string buf(size, '\0');
    if (std::fread(&buf[0], 1, size, fp) != (size_t)size) {
        std::fclose(fp);
        f->error = "short read";
        return f;
    }
    std::fclose(fp);

    const char* p = buf.data();
    const char* end = p + size;
    int n_data = 0;
    std::string tok;
    while (next_token(p, end, tok)) {
        if (tok == "POINTS") {
            std::string n_str, type;
            next_token(p, end, n_str);
            next_token(p, end, type);
            f->n_points = std::atoi(n_str.c_str());
            f->positions.resize((size_t)f->n_points * 3);
            if (!parse_floats(p, end, f->positions.data(),
                              (long)f->n_points * 3)) {
                f->error = "POINTS parse failure";
                return f;
            }
        } else if (tok == "VERTICES" || tok == "LINES" || tok == "POLYGONS" ||
                   tok == "TRIANGLE_STRIPS") {
            std::string a, b;
            next_token(p, end, a);
            next_token(p, end, b);
            if (!skip_floats(p, end, std::atol(b.c_str()))) {
                f->error = tok + " parse failure";
                return f;
            }
        } else if (tok == "POINT_DATA") {
            std::string n_str;
            next_token(p, end, n_str);
            n_data = std::atoi(n_str.c_str());
        } else if (tok == "SCALARS" || tok == "COLOR_SCALARS") {
            bool color = tok == "COLOR_SCALARS";
            Field fld;
            next_token(p, end, fld.name);
            std::string t2;
            next_token(p, end, t2);  // type (or ncomp for COLOR_SCALARS)
            fld.dim = 1;
            if (color) {
                fld.dim = std::atoi(t2.c_str());
            } else {
                // optional numComp before end of line
                const char* save = p;
                std::string maybe;
                if (next_token(p, end, maybe) && std::isdigit((unsigned char)maybe[0]) &&
                    maybe.size() <= 2) {
                    fld.dim = std::atoi(maybe.c_str());
                } else {
                    p = save;
                }
            }
            // optional LOOKUP_TABLE line
            const char* save = p;
            std::string lt;
            if (next_token(p, end, lt) && lt == "LOOKUP_TABLE") {
                std::string name;
                next_token(p, end, name);
            } else {
                p = save;
            }
            fld.data.resize((size_t)n_data * fld.dim);
            if (!parse_floats(p, end, fld.data.data(), (long)n_data * fld.dim)) {
                f->error = "SCALARS parse failure: " + fld.name;
                return f;
            }
            f->fields.push_back(std::move(fld));
        } else if (tok == "VECTORS" || tok == "NORMALS") {
            Field fld;
            next_token(p, end, fld.name);
            if (tok == "NORMALS") fld.name = "normals";
            std::string type;
            next_token(p, end, type);
            fld.dim = 3;
            fld.data.resize((size_t)n_data * 3);
            if (!parse_floats(p, end, fld.data.data(), (long)n_data * 3)) {
                f->error = "VECTORS parse failure: " + fld.name;
                return f;
            }
            f->fields.push_back(std::move(fld));
        } else if (tok == "FIELD") {
            std::string name, cnt;
            next_token(p, end, name);
            next_token(p, end, cnt);
            int n_arrays = std::atoi(cnt.c_str());
            for (int i = 0; i < n_arrays; ++i) {
                Field fld;
                std::string ncomp, ccount, type;
                next_token(p, end, fld.name);
                next_token(p, end, ncomp);
                next_token(p, end, ccount);
                next_token(p, end, type);
                fld.dim = std::atoi(ncomp.c_str());
                long cc = std::atol(ccount.c_str());
                fld.data.resize((size_t)cc * fld.dim);
                if (!parse_floats(p, end, fld.data.data(), cc * fld.dim)) {
                    f->error = "FIELD parse failure: " + fld.name;
                    return f;
                }
                f->fields.push_back(std::move(fld));
            }
        } else if (tok == "#") {
            skip_line(p, end);
        }
        // other tokens (header lines, ASCII, DATASET ...) are skipped
    }
    if (f->n_points == 0 && f->error.empty()) f->error = "no POINTS section";
    return f;
}

const char* vtk_error(void* h) {
    auto* f = (VtkFile*)h;
    return f->error.empty() ? nullptr : f->error.c_str();
}

int vtk_num_points(void* h) { return ((VtkFile*)h)->n_points; }
int vtk_num_fields(void* h) { return (int)((VtkFile*)h)->fields.size(); }
const char* vtk_field_name(void* h, int i) {
    return ((VtkFile*)h)->fields[i].name.c_str();
}
int vtk_field_dim(void* h, int i) { return ((VtkFile*)h)->fields[i].dim; }

void vtk_get_positions(void* h, float* out) {
    auto* f = (VtkFile*)h;
    std::memcpy(out, f->positions.data(), f->positions.size() * sizeof(float));
}

void vtk_get_field(void* h, int i, float* out) {
    auto* f = (VtkFile*)h;
    std::memcpy(out, f->fields[i].data.data(),
                f->fields[i].data.size() * sizeof(float));
}

void vtk_close(void* h) { delete (VtkFile*)h; }

// ---------------------------------------------------------------- writer
int vtk_write(const char* path, int n, const float* positions,
              int n_fields, const char** names, const int* dims,
              const float** fields) {
    FILE* fp = std::fopen(path, "wb");
    if (!fp) return -1;
    std::string buf;
    buf.reserve((size_t)n * 64);
    char line[256];
    buf += "# vtk DataFile Version 3.0\n";
    buf += "File created by norlab_icp_mapper_tpu\n";
    buf += "ASCII\nDATASET POLYDATA\n";
    std::snprintf(line, sizeof line, "POINTS %d float\n", n);
    buf += line;
    for (int i = 0; i < n; ++i) {
        std::snprintf(line, sizeof line, "%.7g %.7g %.7g\n",
                      positions[3 * i], positions[3 * i + 1],
                      positions[3 * i + 2]);
        buf += line;
    }
    std::snprintf(line, sizeof line, "VERTICES %d %d\n", n, 2 * n);
    buf += line;
    for (int i = 0; i < n; ++i) {
        std::snprintf(line, sizeof line, "1 %d\n", i);
        buf += line;
    }
    if (n_fields > 0) {
        std::snprintf(line, sizeof line, "POINT_DATA %d\n", n);
        buf += line;
        for (int fi = 0; fi < n_fields; ++fi) {
            int d = dims[fi];
            const float* data = fields[fi];
            if (d == 3 && std::strcmp(names[fi], "normals") == 0) {
                std::snprintf(line, sizeof line, "NORMALS %s float\n", names[fi]);
            } else if (d == 3) {
                std::snprintf(line, sizeof line, "VECTORS %s float\n", names[fi]);
            } else {
                std::snprintf(line, sizeof line,
                              "SCALARS %s float %d\nLOOKUP_TABLE default\n",
                              names[fi], d);
            }
            buf += line;
            for (int i = 0; i < n; ++i) {
                for (int c = 0; c < d; ++c) {
                    std::snprintf(line, sizeof line, c + 1 == d ? "%.7g\n" : "%.7g ",
                                  data[(size_t)i * d + c]);
                    buf += line;
                }
            }
        }
    }
    size_t written = std::fwrite(buf.data(), 1, buf.size(), fp);
    std::fclose(fp);
    return written == buf.size() ? 0 : -2;
}

}  // extern "C"
