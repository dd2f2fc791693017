// logfmt_native.cpp — report blocks to TSV: a copy of the reference's
// core/native/logfmt_native.cpp, the analog of singleSpMV's C++ log
// formatter (log/format.cpp:10-50): parse ++++/---- delimited key-value
// blocks and emit a TSV table sorted by nNnz ascending.
//
// C ABI, bound with ctypes by core/native/__init__.py, which builds it at
// first use.  The Python formatter in harness/logfmt.py gives the same
// table; this one serves bulk sweep logs (hundreds of MB of blocks).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <sstream>
#include <string>
#include <vector>

namespace {

const char* kDefaultKeys[] = {"Matrix", "Architecture", "MatrixFormat",
                              "Performance(GFLOPS)", "nRow", "nCol", "nNnz"};

bool is_delim(const std::string& line, char ch) {
    if (line.size() < 4) return false;
    for (char c : line)
        if (c != ch && c != '\r') return false;
    return true;
}

std::string trim(const std::string& s) {
    size_t a = s.find_first_not_of(" \t\r\n");
    if (a == std::string::npos) return "";
    size_t b = s.find_last_not_of(" \t\r\n");
    return s.substr(a, b - a + 1);
}

}  // namespace

extern "C" {

// Parses `text`; returns a malloc'd TSV string (caller frees with
// spmv_free_text).  extra_keys: optional '\n'-separated additional columns.
char* spmv_format_logs(const char* text, const char* extra_keys) {
    std::vector<std::string> keys(std::begin(kDefaultKeys),
                                  std::end(kDefaultKeys));
    if (extra_keys && *extra_keys) {
        std::istringstream ek(extra_keys);
        std::string k;
        while (std::getline(ek, k))
            if (!k.empty() &&
                std::find(keys.begin(), keys.end(), k) == keys.end())
                keys.push_back(k);
    }

    std::vector<std::map<std::string, std::string>> blocks;
    std::map<std::string, std::string> cur;
    bool in_block = false;

    std::istringstream in(text);
    std::string line;
    while (std::getline(in, line)) {
        std::string t = trim(line);
        if (is_delim(t, '+')) {
            cur.clear();
            in_block = true;
        } else if (is_delim(t, '-')) {
            if (in_block) blocks.push_back(cur);
            in_block = false;
        } else if (in_block && !t.empty()) {
            size_t tab = line.find('\t');
            if (tab != std::string::npos) {
                cur[trim(line.substr(0, tab))] = trim(line.substr(tab + 1));
            } else {
                size_t sp = t.find_first_of(" \t");
                if (sp != std::string::npos)
                    cur[trim(t.substr(0, sp))] = trim(t.substr(sp + 1));
            }
        }
    }

    std::stable_sort(blocks.begin(), blocks.end(),
                     [](const auto& a, const auto& b) {
                         auto ga = a.find("nNnz"), gb = b.find("nNnz");
                         long long na = ga == a.end() ? 0
                                        : atoll(ga->second.c_str());
                         long long nb = gb == b.end() ? 0
                                        : atoll(gb->second.c_str());
                         return na < nb;
                     });

    std::string out;
    for (size_t i = 0; i < keys.size(); ++i) {
        if (i) out += '\t';
        out += keys[i];
    }
    out += '\n';
    for (auto& b : blocks) {
        for (size_t i = 0; i < keys.size(); ++i) {
            if (i) out += '\t';
            auto it = b.find(keys[i]);
            if (it != b.end()) out += it->second;
        }
        out += '\n';
    }
    if (!out.empty() && out.back() == '\n') out.pop_back();

    char* res = static_cast<char*>(std::malloc(out.size() + 1));
    std::memcpy(res, out.c_str(), out.size() + 1);
    return res;
}

void spmv_free_text(char* p) { std::free(p); }

}  // extern "C"
